"""Stable-Diffusion pipeline context: models, tokenizer, schedule, device.

Counterpart of `geodiffuser_tpu/core/pipeline.py`.  Weights are loaded from a
local diffusers-layout checkpoint (`models.weights.load_sd_checkpoint`) when
`create` is given one, else initialised randomly from a seed (as the JAX
package does without a checkpoint); `models.weights.from_jax_params` and
`load_state_dicts` carry over the JAX package's parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from geodiffuser_tpu_torch.config import ModelConfig, SchedulerConfig
from geodiffuser_tpu_torch.core import scheduler as sched
from geodiffuser_tpu_torch.models.clip_text import CLIPTextEncoder
from geodiffuser_tpu_torch.models import weights as weights_lib
from geodiffuser_tpu_torch.models.tokenizer import CLIPTokenizer, HashTokenizer, load_tokenizer
from geodiffuser_tpu_torch.models.unet import UNet2DCondition
from geodiffuser_tpu_torch.models.vae import AutoencoderKL
from geodiffuser_tpu_torch.utils.profiling import annotate


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class Pipeline:
    config: ModelConfig
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    tokenizer: Union[CLIPTokenizer, HashTokenizer]
    schedule: sched.Schedule
    device: torch.device
    image_size: int = 512

    def __post_init__(self):
        # channels-last filters once, for the channels-last activations of
        # the UNet and the VAE (models/layers.py): cuDNN then transposes no
        # filter on any call.  Results do not depend on it.
        for module in (self.unet, self.vae):
            module.to(memory_format=torch.channels_last)

    @property
    def latent_size(self) -> int:
        return self.image_size // 8

    @staticmethod
    def create(config: ModelConfig = ModelConfig(), image_size: int = 512,
               checkpoint_dir: Optional[str] = None, seed: int = 0, device="cuda") -> "Pipeline":
        """Built directly on `device`: random initialisation from `seed`,
        then, given `checkpoint_dir` (the diffusers layout), its weights
        (cast to `config.dtype`) and its tokenizer when it has one."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
            torch.manual_seed(seed)
            with dev:
                unet = UNet2DCondition(config)
                vae = AutoencoderKL(config)
                text = CLIPTextEncoder(config)
        for m in (unet, vae, text):
            m.to(config.dtype).eval().requires_grad_(False)
        pipe = Pipeline(
            config=config, unet=unet, vae=vae, text_encoder=text,
            tokenizer=load_tokenizer(checkpoint_dir, config.text_vocab_size,
                                     config.text_max_length),
            schedule=sched.make_schedule(SchedulerConfig()), device=dev, image_size=image_size,
        )
        if checkpoint_dir:
            weights_lib.load_sd_checkpoint(checkpoint_dir, pipe)
        return pipe

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}

    def load_state_dicts(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load the given ones of the {"unet", "vae", "text"} state_dicts
        (strict), cast to the model type."""
        for name, module in self.modules().items():
            if name in state_dicts:
                sd = {k: v.to(self.device, self.config.dtype)
                      for k, v in state_dicts[name].items()}
                module.load_state_dict(sd, strict=True)

    @torch.no_grad()
    def encode_text(self, prompts: Sequence[str]) -> torch.Tensor:
        """List[str] -> (B, 77, cross_dim) float32 embeddings."""
        with annotate("gd.text.encode"):
            ids = torch.as_tensor(self.tokenizer(list(prompts)), dtype=torch.long,
                                  device=self.device)
            return self.text_encoder(ids)

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) float in [0, 1] -> (1, h, w, 4) scaled latents
        (image2latent, diffusion.py:71-97)."""
        return self.encode_images(image[None])

    @torch.no_grad()
    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(E, H, W, 3) float in [0, 1] -> (E, h, w, 4) scaled latents: one
        VAE pass for a batch of edits."""
        with annotate("gd.vae.encode"):
            x = images.float() * 2.0 - 1.0
            return self.vae.encode(x) * self.config.vae_scaling_factor

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(S, h, w, 4) scaled latents -> (S, H, W, 3) uint8 (latent2image,
        diffusion.py:62-68)."""
        with annotate("gd.vae.decode"):
            img = self.vae.decode(latents / self.config.vae_scaling_factor)
            img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
            return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()

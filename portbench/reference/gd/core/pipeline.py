"""The reference's Stable-Diffusion pipeline: models, tokenizer, schedule.

A frozen copy of the port's `core/pipeline.py` in float32, without its
checkpoint loading: `build` makes the modules on the meta device and takes
the benchmark's seeded weights (`portbench/weights.py`), the same values
the program is given.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from portbench import weights
from portbench.reference.gd.config import ModelConfig, SchedulerConfig
from portbench.reference.gd.core import scheduler as sched
from portbench.reference.gd.models.clip_text import CLIPTextEncoder
from portbench.reference.gd.models.tokenizer import HashTokenizer
from portbench.reference.gd.models.unet import UNet2DCondition
from portbench.reference.gd.models.vae import AutoencoderKL

MODULES = {"unet": UNet2DCondition, "vae": AutoencoderKL, "text": CLIPTextEncoder}


@dataclasses.dataclass
class Pipeline:
    config: ModelConfig
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    tokenizer: HashTokenizer
    schedule: sched.Schedule
    device: torch.device
    image_size: int = 512

    @property
    def latent_size(self) -> int:
        return self.image_size // 8

    @staticmethod
    def build(config: ModelConfig, image_size: int, seed: int, device) -> "Pipeline":
        """The models in `config.dtype` with the benchmark's weights from
        `seed`, on `device`."""
        dev = torch.device(device)
        mods = weights.build(MODULES, config, config.dtype, seed, dev)
        return Pipeline(
            config=config, unet=mods["unet"], vae=mods["vae"], text_encoder=mods["text"],
            tokenizer=HashTokenizer(config.text_vocab_size, config.text_max_length),
            schedule=sched.make_schedule(SchedulerConfig()), device=dev, image_size=image_size,
        )

    @torch.no_grad()
    def encode_text(self, prompts: Sequence[str]) -> torch.Tensor:
        """List[str] -> (B, 77, cross_dim) float32 embeddings."""
        ids = torch.as_tensor(self.tokenizer(list(prompts)), dtype=torch.long, device=self.device)
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
        x = images.float() * 2.0 - 1.0
        return self.vae.encode(x) * self.config.vae_scaling_factor

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """(S, h, w, 4) scaled latents -> (S, H, W, 3) uint8 (latent2image,
        diffusion.py:62-68)."""
        img = self.vae.decode(latents / self.config.vae_scaling_factor)
        img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()

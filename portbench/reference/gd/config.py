"""Typed configuration for the PyTorch port of GeoDiffuser.

Counterpart of `geodiffuser_tpu/config.py`, with torch dtypes in place of
`jax.numpy` ones.  Values are static Python configuration; runtime state lives
in `portbench.reference.gd.core.edit_state`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Point-splat parameters (reference warp_utils.py:50-66) and the
    per-step annealing of the edit loop (editor.py:154-156)."""

    radius: float = 1.3
    tau: float = 1.0
    points_per_pixel: int = 15
    rad_pow: int = 2
    z_beta: float = 20.0  # occlusion sharpness for the soft z-buffer weighting

    radius_decay: float = 0.95
    tau_decay: float = 0.8
    tau_floor: float = 0.1
    ppp_decay: float = 0.9
    ppp_floor: int = 4


# Loss-weight tables (reference attention_processors.py:729-730, 1015-1016;
# large_scale_editor.py:233-283).
EDITOR_LOSS_WEIGHTS: Mapping[str, Mapping[str, float]] = {
    "self": {"sim": 55.0, "movement": 30.5, "removal": 2.6, "smoothness": 30.0, "amodal": 80.5},
    "cross": {"sim": 45.0, "movement": 30.34, "removal": 2.6, "smoothness": 15.0, "amodal": 3.5},
}
REMOVER_LOSS_WEIGHTS: Mapping[str, Mapping[str, float]] = {
    "self": {"sim": 55.0, "movement": 0.0, "removal": 4.6, "smoothness": 30.0, "amodal": 0.0},
    "cross": {"sim": 45.0, "movement": 0.0, "removal": 4.6, "smoothness": 15.0, "amodal": 0.0},
}
STITCH_LOSS_WEIGHTS: Mapping[str, Mapping[str, float]] = {
    "self": {"sim": 120.0, "movement": 40.0, "removal": 0.0, "smoothness": 2.0, "amodal": 0.0},
    "cross": {"sim": 30.0, "movement": 5.0, "removal": 0.0, "smoothness": 1.0, "amodal": 0.0},
}


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Full configuration of one geometric edit (defaults: the batch
    driver's tuned `geometry_editor` values, large_scale_editor.py:199-299)."""

    edit_type: str = "geometry_editor"  # geometry_editor | geometry_remover | geometry_stitch
    image_size: int = 512
    num_ddim_steps: int = 50
    guidance_scale: float = 3.0
    prompt: str = ""
    uncond_text: str = ""
    seed: int = 1234

    optimize_steps: float = 0.65
    skip_optim_steps: int = 2
    lr: float = 0.03
    latent_replace: float = 0.1
    obj_edit_step: float = 0.9
    cross_replace_steps: float = 0.95
    self_replace_steps: float = 0.95
    optimize_embeddings: bool = True
    optimize_latents: bool = True
    use_optimizer: bool = True
    sgd_momentum: float = 0.9
    use_adaptive_optimization: bool = True
    removal_loss_value: float = -1.5
    fast_start_steps: float = 0.0
    num_first_optim_steps: int = 1
    perform_inversion: bool = False
    cache_inversion: bool = True

    focal_length: float = 550.0
    mask_dilate_remover: int = 5
    amodal_erode: int = 3

    splat: SplatConfig = dataclasses.field(default_factory=SplatConfig)
    loss_weights: Optional[Mapping[str, Mapping[str, float]]] = None
    # False replicates the reference's no-op constraints
    # (attention_sharing.py:37-42); see geodiffuser_tpu/config.py.
    apply_attention_constraints: bool = False

    def resolved_loss_weights(self) -> Mapping[str, Mapping[str, float]]:
        if self.loss_weights is not None:
            return self.loss_weights
        if self.edit_type == "geometry_remover":
            return REMOVER_LOSS_WEIGHTS
        if self.edit_type == "geometry_stitch":
            return STITCH_LOSS_WEIGHTS
        return EDITOR_LOSS_WEIGHTS

    @property
    def latent_size(self) -> int:
        return self.image_size // 8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SD-1.x architecture (defaults: SD-1.4/1.5); `sd21()` gives SD-2.1's.
    `dtype` is both the weight and the activation type of the port's
    modules."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: int = 8
    # SD-2.x per-down-block head counts (diffusers attention_head_dim list,
    # (5, 10, 20, 20) = 64-wide heads); None: num_attention_heads everywhere
    attention_head_dims: Optional[Tuple[int, ...]] = None
    cross_attention_dim: int = 768
    transformer_layers_per_block: int = 1
    norm_num_groups: int = 32
    # SD-2.x Transformer2DModel: Linear proj_in/proj_out; SD-1.x: 1x1 convs
    use_linear_projection: bool = False
    vae_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    vae_layers_per_block: int = 2
    vae_latent_channels: int = 4
    vae_scaling_factor: float = 0.18215
    text_vocab_size: int = 49408
    text_hidden_size: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_max_length: int = 77
    text_hidden_act: str = "quick_gelu"   # SD-2.x OpenCLIP: "gelu" (exact erf)
    dtype: torch.dtype = torch.bfloat16

    def heads_for_block(self, block_idx: int) -> int:
        if self.attention_head_dims is not None:
            return self.attention_head_dims[block_idx]
        return self.num_attention_heads

    @staticmethod
    def sd21() -> "ModelConfig":
        """stabilityai/stable-diffusion-2-1: 64-wide heads ((5, 10, 20, 20)
        per block), Linear transformer projections, the OpenCLIP ViT-H text
        tower (1024 wide, 23 layers: the penultimate layer, gelu).  The
        model of the DIFT featurizer behind the MD metric
        (evaluation/dift.py)."""
        return ModelConfig(
            attention_head_dims=(5, 10, 20, 20),
            cross_attention_dim=1024,
            use_linear_projection=True,
            text_hidden_size=1024,
            text_layers=23,
            text_heads=16,
            text_hidden_act="gelu",
        )

    @staticmethod
    def tiny_sd21() -> "ModelConfig":
        """A miniature SD-2.x config (per-block heads, Linear projections,
        gelu) for CPU tests (same values as the JAX one)."""
        return dataclasses.replace(
            ModelConfig.tiny(),
            attention_head_dims=(1, 2, 2, 2),
            use_linear_projection=True,
            text_hidden_act="gelu",
        )

    @staticmethod
    def tiny() -> "ModelConfig":
        """A miniature config for CPU tests (same values as the JAX one)."""
        return ModelConfig(
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            num_attention_heads=2,
            cross_attention_dim=32,
            norm_num_groups=8,
            vae_block_out_channels=(16, 16, 32, 32),
            vae_layers_per_block=1,
            text_vocab_size=1000,
            text_hidden_size=32,
            text_layers=2,
            text_heads=2,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDIM schedule parameters (reference diffusion.py:110, inversion.py:143)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False

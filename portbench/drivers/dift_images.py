"""DIFT features of one image at a time through the port's
`SDFeaturizer.__call__` (the device half of MD scoring), one client in a
closed loop.

Image i of the window is scene i mod `pool` of the traffic (each seeded by
(seed, scene)); its noise draws come from a generator on the device seeded
by (seed, i), handed to the program, and drawn again alike by the
reference.  The driver keeps every image's features on the host with the
program's VAE latent and text embedding; after the window the reference
featurizes a sample of the images, drawn from the seed (`check`).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, program, scenes
from portbench.work import model as work_model

RATE = ("dift_images_per_s", "images/s")
UNIT = "image"
# the host spans this driver puts around the calls into each layer
LABELS = ("SDFeaturizer.__call__", "SDFeaturizer.features", "pipeline.unet", "encode_image",
          "encode_text")


def noise_seed(seed: int, index: int) -> int:
    return int(scenes.rng(seed, index, 1 << 22).integers(1 << 62))


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.size = config["image_size"]
        self.images = None
        self.captures: Dict[int, Dict] = {}
        self.cap = None

    def setup(self) -> None:
        from geodiffuser_tpu_torch.evaluation.dift import SDFeaturizer
        from geodiffuser_tpu_torch.kernels import _build

        c, d = self.config, self.config["dift"]
        phases = program.Phases("set-up")
        pipe = program.pipeline(c["model"], c["dtype"], self.size, self.seed, self.device)
        phases.done("weights")
        if self.device.type == "cuda":
            _build.lib()
        phases.done("kernels")
        self.images = scenes.images(self.size, self.traffic["scene"], self.seed,
                                    range(self.traffic["pool"]))
        phases.done("scenes")
        self.feat = SDFeaturizer(pipe, t=d["t"], up_block=d["up_block"], ensemble=d["ensemble"],
                                 seed=self.seed)
        pipe.unet = program.Unet(pipe.unet)
        program.wrap(self.feat, "features", "SDFeaturizer.features")
        self._capture(pipe)
        self.feat(self.images[0], self.traffic["prompt"],
                  torch.Generator(device=self.device).manual_seed(0))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        phases.done("warm-up")
        phases.report()

    def _capture(self, pipe) -> None:
        def latent(tok, out):
            self.cap["latent"] = program.host(out)

        def context(tok, out):
            self.cap["context"] = program.host(out)

        program.wrap(pipe, "encode_image", "encode_image",
                     lambda a: self.cap is not None or None, latent)
        program.wrap(pipe, "encode_text", "encode_text",
                     lambda a: self.cap is not None or None, context)

    def unit(self, index: int) -> Dict:
        image = self.images[index % len(self.images)]
        gen = torch.Generator(device=self.device).manual_seed(noise_seed(self.seed, index))
        self.cap = {}
        t0 = time.perf_counter()
        with torch.profiler.record_function("SDFeaturizer.__call__"):
            feats = self.feat(image, self.traffic["prompt"], gen)
        seconds = time.perf_counter() - t0
        self.cap["features"] = torch.from_numpy(feats)
        self.captures[index] = self.cap
        self.cap = None
        return {"work": 1, "seconds": seconds}

    def release(self) -> None:
        self.feat = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def work(self, units: List[Dict]) -> Dict[str, float]:
        return work_model.dift_work(self.config, len(units))

    def sample(self) -> List[int]:
        done = sorted(self.captures)
        n = min(self.traffic["check_images"], len(done))
        pick = scenes.rng(self.seed, 1 << 23).choice(len(done), size=n, replace=False)
        return [done[i] for i in sorted(pick)]

    def check(self, lower: bool = False) -> Dict[str, Dict[str, float]]:
        picks = self.sample()
        ref = self._reference_pipeline(False)
        want = {i: self.reference_outputs(ref, i) for i in picks}
        del ref
        got = {i: {k: self.captures[i][k] for k in ("latent", "context", "features")}
               for i in picks}
        out = {"program": gaps(got, want)}
        if lower:
            ctl = self._reference_pipeline(True)
            out["control"] = gaps({i: self.reference_outputs(ctl, i) for i in picks}, want)
        return out

    def _reference_pipeline(self, lower: bool):
        from portbench.reference import lower as lower_mod
        from portbench.reference.gd import config as ref_cfg
        from portbench.reference.gd.core.pipeline import Pipeline

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        pipe = Pipeline.build(program.model_config(ref_cfg, self.config["model"], "float32"),
                              self.size, self.seed, self.device)
        if lower:
            lower_mod.to_fp8_(pipe.unet, pipe.vae, pipe.text_encoder)
        return pipe

    @torch.no_grad()
    def reference_outputs(self, pipe, index: int) -> Dict[str, torch.Tensor]:
        """DIFT as `dift_sd.py` defines it, on the reference: the latent
        noised to t with each draw, one UNet pass, up block `up_block`'s
        output, the mean over the ensemble."""
        d = self.config["dift"]
        img = self.images[index % len(self.images)].astype(np.float32) / 255.0
        latent = pipe.encode_images(torch.as_tensor(img, device=self.device)[None])
        ctx = pipe.encode_text([self.traffic["prompt"]])
        gen = torch.Generator(device=self.device).manual_seed(noise_seed(self.seed, index))
        a = pipe.schedule.alphas_cumprod[d["t"]].to(self.device)
        acc = 0.0
        for _ in range(d["ensemble"]):
            noise = torch.randn(tuple(latent.shape), generator=gen, device=self.device)
            noised = torch.sqrt(a) * latent + torch.sqrt(1.0 - a) * noise
            _, taps = pipe.unet(noised, d["t"], ctx, features=True)
            acc = acc + taps[f"up_block_{d['up_block']}"].float()
        return dict(latent=latent.cpu(), context=ctx.cpu(),
                    features=(acc[0] / d["ensemble"]).cpu())


def gaps(got: Dict[int, Dict], want: Dict[int, Dict]) -> Dict[str, float]:
    """The largest relative L2 gap over the sampled images, of the VAE
    latent, the text embedding and the ensemble-mean features."""
    return {name: max(compare.rel(got[i][key], want[i][key]) for i in want)
            for name, key in (("enc", "latent"), ("text", "context"), ("feat", "features"))}

"""Lockstep groups of edits through the port's `ShardedEditSession.run_batch`
(the batch driver's `--group-size` sweep), closed loop, groups back to back.

Each group holds `group_size` distinct scenes with their own transforms
(`portbench/scenes.py`).  While a group runs, the driver keeps host copies
of what the timed path itself produced at one inversion step (the UNet's
noise prediction and the step), one optimize step (its losses, the removal
correlation's maxima and its update), the CFG step after it and the plain
CFG step after that (the noise prediction of every stream through the
edited attention, and the step), the VAE encode and the decode (steps
fixed by `capture_plan`); after the window the reference recomputes one
group's, drawn from the seed, from the same inputs (`check`).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, program, scenes
from portbench.work import model as work_model

RATE = ("edits_per_s", "edits/s")
UNIT = "edit"
# the host spans this driver puts around the calls into each layer
LABELS = ("run_batch", "preprocess_batch", "ddim_invert", "_optimize_step", "_cfg_step",
          "_decode_post", "decode_latents", "removal_correlation", "pipeline.unet")


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.size = config["image_size"]
        self.e = traffic["group_size"]
        self.groups: Dict[int, Dict[str, np.ndarray]] = {}
        self.captures: Dict[int, Dict] = {}
        self.cap = None      # the running group's captures, None outside groups
        self.plan = None
        self.corr = None     # the captured optimize step's correlation maxima

    # ------------------------------------------------------------ inputs
    def inputs(self, index: int) -> Dict[str, np.ndarray]:
        if index not in self.groups:
            self.groups[index] = scenes.group(self.size, self.traffic, self.seed, index, self.e)
        return self.groups[index]

    def _steps(self):
        from portbench.reference.gd import config as ref_cfg
        from portbench.reference.gd.core import editor as ref_editor

        cfg = program.edit_config(ref_cfg, self.config["edit"],
                                  edit_type=self.traffic["edit_type"], image_size=self.size)
        plans = [ref_editor.step_plan(cfg, i) for i in range(cfg.num_ddim_steps)]
        return cfg, plans

    def capture_plan(self) -> Dict[str, int]:
        """The steps whose outputs every group keeps: the inversion step in
        the middle of the schedule, the optimize step in the middle of the
        optimize window and the plain CFG step after it.  Fixed steps keep
        the compared numbers' scale alike from seed to seed (it differs
        from step to step); the group that is compared is drawn from the
        seed (`sample`)."""
        _, plans = self._steps()
        opt = [i for i, p in enumerate(plans) if p["optimize"] and i > 0]
        mid = opt[len(opt) // 2]
        return dict(inv=len(plans) // 2, opt=mid, cfg=mid + 1)

    # ------------------------------------------------------------- setup
    def setup(self) -> None:
        from geodiffuser_tpu_torch import config as port_cfg
        from geodiffuser_tpu_torch.core import inversion
        from geodiffuser_tpu_torch.kernels import _build, removal_corr
        from geodiffuser_tpu_torch.parallel.batch import ShardedEditSession

        c = self.config
        phases = program.Phases("set-up")
        pipe = program.pipeline(c["model"], c["dtype"], self.size, self.seed, self.device)
        phases.done("weights")
        if self.device.type == "cuda":
            _build.lib()
        phases.done("kernels")
        cfg = program.edit_config(port_cfg, c["edit"], edit_type=self.traffic["edit_type"],
                                  image_size=self.size)
        self.session = ShardedEditSession(pipe, cfg, device=self.device)
        self._instrument(inversion, removal_corr)
        for g in range(self.traffic["pool"]):
            self.inputs(g)
        phases.done("scenes")
        warm = ShardedEditSession(pipe, dataclasses.replace(
            cfg, num_ddim_steps=self.traffic["warmup_steps"]), device=self.device)
        self._run(warm, self.inputs(0))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        phases.done("warm-up")
        phases.report()

    def _instrument(self, inversion, removal_corr) -> None:
        s = self.session
        s.pipeline.unet = self.unet = program.Unet(s.pipeline.unet)
        program.wrap(s, "preprocess_batch", "preprocess_batch")
        program.wrap(s, "_decode_post", "_decode_post")
        # the port's module functions are restored by `release`
        self._restore = [(inversion, "ddim_invert", program.wrap(
            inversion, "ddim_invert", "ddim_invert", self._inv_in, self._inv_out))]
        program.wrap(s, "_optimize_step", "_optimize_step", self._opt_in, self._opt_out)
        program.wrap(s, "_cfg_step", "_cfg_step", self._cfg_in, self._cfg_out)
        program.wrap(s.pipeline, "decode_latents", "decode_latents", self._dec_in, self._dec_out)
        self._restore.append((removal_corr, "removal_correlation", program.wrap(
            removal_corr, "removal_correlation", "removal_correlation",
            lambda a: self.corr is not None or None, self._corr_out)))

    # ---------------------------------------------------------- captures
    def _inv_in(self, a):
        if self.cap is not None:
            self.unet.arm(self.plan["inv"])
            return dict(latent0=program.host(a["latent"]), ctx_uncond=program.host(a["context_uncond"]),
                        ctx_cond=program.host(a["context_cond"]), cfg_free=a["cfg_free"])

    def _inv_out(self, tok, out):
        k = self.plan["inv"]
        self.cap["inv"] = dict(tok, k=k, x_k=program.host(out[0][k]),
                               x_next=program.host(out[0][k + 1]), eps=program.host(self.unet.take()))

    def _opt_in(self, a):
        if self.cap is not None and a["i"] == self.plan["opt"]:
            self.corr = []
            return dict(i=a["i"], latents2=program.host(a["latents2"]),
                        context4=program.host(a["context4"]), sgd=program.host(a["sgd_state"]),
                        weights=program.host(a["weights"]))

    def _opt_out(self, tok, out):
        keys, vals = out[3]
        self.cap["opt"] = dict(tok, latents2_out=program.host(out[0]),
                               context4_out=program.host(out[1]), keys=list(keys),
                               vals=program.host(vals), corr=program.host(self.corr))
        self.corr = None

    def _corr_out(self, tok, out):
        self.corr.append((out[0].detach().clone(), out[1].detach().clone()))

    def _cfg_in(self, a):
        if self.cap is not None and a["i"] in (self.plan["opt"], self.plan["cfg"]):
            self.unet.arm()
            return dict(i=a["i"], taps=a["taps"] is not None,
                        latents2=program.host(a["latents2"]), context4=program.host(a["context4"]),
                        pinned=program.host(a["pinned_base"]), weights=program.host(a["weights"]))

    def _cfg_out(self, tok, out):
        self.cap["cfg_taps" if tok["taps"] else "cfg"] = dict(
            tok, out=program.host(out), eps=program.host(self.unet.take()))

    def _dec_in(self, a):
        if self.cap is not None:
            return dict(latents=program.host(a["latents"]))

    def _dec_out(self, tok, out):
        self.cap["dec"] = dict(tok, images=np.array(out))

    # ------------------------------------------------------------ window
    def _run(self, session, inp):
        prompts = [self.traffic["prompt"]] * self.e
        with torch.profiler.record_function("run_batch"):
            return session.run_batch(inp["images"], inp["depths"], inp["masks"],
                                     inp["transforms"], prompts=prompts)

    def unit(self, index: int) -> Dict:
        """Group `index`, start to end: the window's unit of work."""
        inp = self.inputs(index)
        self.cap, self.plan = {}, self.capture_plan()
        t0 = time.perf_counter()
        res = self._run(self.session, inp)
        seconds = time.perf_counter() - t0
        self.cap["plan"] = self.plan
        self.captures[index] = self.cap
        self.cap = None
        return {"work": self.e, "seconds": seconds, "timings": dict(res.timings)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for owner, attr, fn in getattr(self, "_restore", []):
            setattr(owner, attr, fn)
        self._restore, self.cap = [], None
        self.session = self.unet = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- work
    def work(self, units: List[Dict]) -> Dict[str, float]:
        """Model FLOPs and attention and correlation work of the window's
        groups, from the configuration and the reference's schedule."""
        cfg, plans = self._steps()
        rows, full_blend = self.mask_rows(len(units))
        return work_model.edit_group_work(self.config, cfg, plans, self.e, rows, full_blend)

    def mask_rows(self, groups: int):
        """Each edit's live inpaint and warped rows at each loss resolution
        ([{"inpaint": {res: n}, "warped": {res: n}}]) and each group's choice
        of the full-row blend, from the reference's mask sets of the first
        `groups` groups' scenes."""
        from portbench.reference.gd.core import editor as ref_editor

        cfg, _ = self._steps()
        sess = ref_editor.EditSession(_NoModels(self.size, self.device), cfg)
        rows, full_blend = [], []
        for g in range(groups):
            _, ms = sess.preprocess_batch(*self._tensors(self.inputs(g), 0, self.e))
            loss_res = {r: m for r, m in ms.items() if m.inpaint_row_mask is not None}
            full_blend.append(sess._full_blend(ms))
            for j in range(self.e):
                rows.append({kind: {r: int(getattr(m, f"{kind}_row_mask")[j].sum())
                                    for r, m in loss_res.items()}
                             for kind in ("inpaint", "warped")})
        return rows, full_blend

    def _tensors(self, inp, a: int, b: int):
        f32 = dict(dtype=torch.float32, device=self.device)
        image = torch.as_tensor(inp["images"][a:b].astype(np.float32) / 255.0, **f32)
        mask = (torch.as_tensor(inp["masks"][a:b], **f32) > 0.5).float()
        return (image, torch.as_tensor(inp["depths"][a:b], **f32), mask,
                torch.as_tensor(inp["transforms"][a:b], **f32))

    # ------------------------------------------------------------- check
    def sample(self) -> int:
        done = sorted(self.captures)
        return done[int(scenes.rng(self.seed, 1 << 21).integers(len(done)))]

    def check(self, lower: bool = False) -> Dict[str, Dict[str, float]]:
        """{"program": gaps} and, with `lower`, {"control": gaps}: the
        program's outputs of the sampled group, and the control's from the
        same inputs, each against the float32 reference."""
        g = self.sample()
        cap = self.captures[g]
        ref = self._reference_pipeline(False)
        want = self.reference_outputs(ref, cap, self.inputs(g))
        del ref
        out = {"program": gaps(program_outputs(cap), want, cap)}
        if lower:
            ctl = self._reference_pipeline(True)
            out["control"] = gaps(self.reference_outputs(ctl, cap, self.inputs(g)), want, cap)
        return out

    def _reference_pipeline(self, lower: bool):
        from portbench.reference import lower as lower_mod
        from portbench.reference.gd.core.pipeline import Pipeline
        from portbench.reference.gd import config as ref_cfg

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        cfg = program.model_config(ref_cfg, self.config["model"], "float32")
        pipe = Pipeline.build(cfg, self.size, self.seed, self.device)
        if lower:
            lower_mod.to_fp8_(pipe.unet, pipe.vae, pipe.text_encoder)
        return pipe

    @torch.no_grad()
    def reference_outputs(self, pipe, cap, inp) -> Dict[str, torch.Tensor]:
        """The reference's outputs from the captured steps' inputs, one edit
        at a time (the group's edits are independent)."""
        from portbench.reference.gd.core import edit_state as ref_state
        from portbench.reference.gd.core import editor as ref_editor
        from portbench.reference.gd.core import scheduler as ref_sched
        from portbench.reference.gd.kernels import removal_corr as ref_rc

        dev = self.device
        cfg, plans = self._steps()
        sess = ref_editor.EditSession(pipe, cfg)
        out: Dict[str, object] = {}
        images, depths, masks, tfs = self._tensors(inp, 0, self.e)
        out["enc"] = torch.cat([pipe.encode_images(images[j:j + 1]) for j in range(self.e)]).cpu()
        out["text"] = pipe.encode_text([cfg.uncond_text]).cpu()

        inv = cap["inv"]
        k = inv["k"]
        t = int(ref_sched.inverse_timesteps(cfg.num_ddim_steps, 1000)[k])
        xs, eps_inv = [], []
        for j in range(self.e):
            x = inv["x_k"][j:j + 1].to(dev)
            if inv["cfg_free"]:
                eps = pipe.unet(x, t, inv["ctx_cond"][j:j + 1].to(dev))
            else:
                ctx = torch.cat([inv["ctx_uncond"][j:j + 1], inv["ctx_cond"][j:j + 1]]).to(dev)
                e2 = pipe.unet(torch.cat([x, x]), t, ctx)
                eps = e2[:1] + cfg.guidance_scale * (e2[1:] - e2[:1])
            eps_inv.append(eps.cpu())
            xs.append(ref_sched.ddim_inverse_step(pipe.schedule, eps, t, x, cfg.num_ddim_steps).cpu())
        out["inv"], out["inv_eps"] = torch.cat(xs), torch.cat(eps_inv)

        opt, cft, cfs = cap["opt"], cap["cfg_taps"], cap["cfg"]
        lat, emb, vals, corr, cfg_taps, cfg_slim, eps_taps, eps_slim = ([] for _ in range(8))
        unet = pipe.unet = program.Unet(pipe.unet)
        for j in range(self.e):
            tfs_j, ms = sess.preprocess_batch(*self._tensors(inp, j, j + 1))
            full_blend = sess._full_blend(ms)
            pick = lambda tree: _edit(tree, j, dev)

            p = plans[opt["i"]]
            wm = (ref_state.build_warp_matrices(ms, p["warp_radius"], p["warp_tau"],
                                                cfg.splat.z_beta)
                  if sess.mode == "editor" else None)
            sgd = None
            if opt["sgd"] is not None:
                sgd = ref_editor.optimization.SGDState(**pick(opt["sgd"]))
            ref_rc.RECORD = []
            with torch.enable_grad():
                l2, c4, _, (keys, v), taps = sess._optimize_step(
                    pick(opt["latents2"]), pick(opt["context4"]), p["t"], ms, opt["i"],
                    pick(opt["weights"]), p["radius"], p["tau"], p["lr"], sgd, wm,
                    p["self_window"], p["past_obj"], fetch_logs=False)
            corr.append([(a.cpu(), b.cpu()) for a, b in ref_rc.RECORD])
            ref_rc.RECORD = None
            lat.append(l2[:, 1].cpu())
            emb.append(c4[:, 3].cpu())
            vals.append(_log_vector(keys, v).cpu())
            unet.arm()
            cfg_taps.append(self._ref_cfg(sess, cft, plans, ms, wm, full_blend, taps, j)[:, 1])
            eps_taps.append(unet.take().cpu())

            p = plans[cfs["i"]]
            wm = (ref_state.build_warp_matrices(ms, p["warp_radius"], p["warp_tau"],
                                                cfg.splat.z_beta)
                  if sess.mode == "editor" else None)
            unet.arm()
            cfg_slim.append(self._ref_cfg(sess, cfs, plans, ms, wm, full_blend, None, j)[:, 1])
            eps_slim.append(unet.take().cpu())
            del tfs_j, ms, wm, taps
        pipe.unet = unet.inner
        out.update(opt_lat=torch.cat(lat), opt_emb=torch.cat(emb), opt_loss=torch.cat(vals),
                   cfg_taps=torch.cat(cfg_taps), cfg=torch.cat(cfg_slim),
                   cfg_taps_eps=torch.cat(eps_taps), cfg_eps=torch.cat(eps_slim))
        out["corr"] = _corr_by_edit(corr)

        dec = cap["dec"]["latents"]
        imgs = [pipe.decode_latents(dec[j:j + 2].to(dev)) for j in range(0, len(dec), 2)]
        out["dec"] = torch.as_tensor(np.concatenate(imgs))
        return out

    def _ref_cfg(self, sess, rec, plans, ms, wm, full_blend, taps, j):
        dev = self.device
        p = plans[rec["i"]]
        return sess._cfg_step(
            _edit(rec["latents2"], j, dev), _edit(rec["context4"], j, dev), p["t"], ms, rec["i"],
            _edit(rec["weights"], j, dev), p["radius"], p["tau"], _edit(rec["pinned"], j, dev),
            p["replace"], wm, p["self_window"], p["past_obj"], full_blend, taps=taps).cpu()


class _NoModels:
    """What the reference's preprocessing reads of a pipeline."""

    def __init__(self, size: int, device):
        self.latent_size = size // 8
        self.device = device


def _edit(tree, j: int, device):
    """Edit j's slice (kept as a group of one) of a captured tensor, dict or
    list, on `device`."""
    if torch.is_tensor(tree):
        return tree[j:j + 1].to(device)
    if isinstance(tree, dict):
        return {k: _edit(v, j, device) for k, v in tree.items()}
    return tree


def _log_vector(keys, vals) -> torch.Tensor:
    """An optimize step's (E, 1 + K) logs without the layer count: the total
    loss and each logged loss term, summed over the layers."""
    keep = [0] + [1 + n for n, k in enumerate(keys) if k != "num_layers"]
    return vals[:, keep].float()


def _corr_by_edit(per_edit) -> List[torch.Tensor]:
    """Per correlation call, the edits' (H, K) maxima stacked as the
    program's (E * H, K) group launch lays them out, p_in then p_bg."""
    calls = len(per_edit[0])
    return [torch.cat([torch.cat([per_edit[j][c][m] for j in range(len(per_edit))])
                       for m in (0, 1)]) for c in range(calls)]


def program_outputs(cap) -> Dict[str, object]:
    """The program's outputs as `reference_outputs` lays them out."""
    opt = cap["opt"]
    return dict(
        enc=cap["inv"]["latent0"], text=cap["inv"]["ctx_uncond"][:1], inv=cap["inv"]["x_next"],
        inv_eps=cap["inv"]["eps"], cfg_taps_eps=cap["cfg_taps"]["eps"], cfg_eps=cap["cfg"]["eps"],
        opt_lat=opt["latents2_out"][:, 1], opt_emb=opt["context4_out"][:, 3],
        opt_loss=_log_vector(opt["keys"], opt["vals"]),
        corr=[torch.cat([a, b]) for a, b in opt["corr"]],
        cfg_taps=cap["cfg_taps"]["out"][:, 1], cfg=cap["cfg"]["out"][:, 1],
        dec=torch.as_tensor(cap["dec"]["images"]))


def gaps(got: Dict, want: Dict, cap) -> Dict[str, float]:
    """Each compared number: the relative L2 gap of a noise prediction,
    loss, correlation maximum, latent or image, and of a step (an inversion
    step, the optimize step's update of the edit latent and embedding, a
    CFG step's move of the edit latent) relative to the reference's step,
    so that a step left undone reads 1."""
    opt = cap["opt"]
    live = [w > -1e8 for w in want["corr"]]
    if len(got["corr"]) != len(want["corr"]):
        corr = float("inf")
    else:
        corr = compare.rel(torch.cat([g[m] for g, m in zip(got["corr"], live)]),
                           torch.cat([w[m] for w, m in zip(want["corr"], live)]))
    return dict(
        enc=compare.rel(got["enc"], want["enc"]),
        text=compare.rel(got["text"], want["text"]),
        inv_eps=compare.rel(got["inv_eps"], want["inv_eps"]),
        inv_step=compare.rel_step(got["inv"], want["inv"], cap["inv"]["x_k"]),
        opt_loss=compare.rel(got["opt_loss"], want["opt_loss"]),
        corr=corr,
        opt_step=compare.rel_step(got["opt_lat"], want["opt_lat"], opt["latents2"][:, 1]),
        opt_emb_step=compare.rel_step(got["opt_emb"], want["opt_emb"], opt["context4"][:, 3]),
        cfg_taps_eps=compare.rel(got["cfg_taps_eps"], want["cfg_taps_eps"]),
        cfg_taps_step=compare.rel_step(got["cfg_taps"], want["cfg_taps"],
                                       cap["cfg_taps"]["latents2"][:, 1]),
        cfg_eps=compare.rel(got["cfg_eps"], want["cfg_eps"]),
        cfg_step=compare.rel_step(got["cfg"], want["cfg"], cap["cfg"]["latents2"][:, 1]),
        dec=compare.rel(got["dec"].float(), want["dec"].float()),
    )

"""Gradio app over `ui/callbacks.py`, with the reference's whole surface.

Counterpart of `geodiffuser_tpu/ui/app.py`: the two-tab reference UI
(geo_diff_ui.py:62-1272, "Editing Real Image" and "Inpainting") with the
advanced accordion (:291-527) and experiment save / load.  gradio is not a
dependency of the port: it is imported only when the app is built, and
`ui/serve.py` serves the same surface without it.
"""

from __future__ import annotations

from geodiffuser_tpu_torch.ui import callbacks as cb


def _advanced_accordion(gr, remover: bool = False):
    """The reference advanced-controls accordion (geo_diff_ui.py:291-527).
    Returns the ordered component list matching AdvancedOptions fields."""
    d = cb.REMOVER_ADVANCED_DEFAULTS if remover else {}
    g = d.get  # default-aware getter

    with gr.Accordion("Generation Parameters", open=False):
        with gr.Row():
            guidance = gr.Slider(0.0, 10.0, g("guidance_scale", 3.0), step=0.1,
                                 label="g_scale", info="Guidance Scale")
            cross_rep = gr.Slider(0, 1, g("cross_replace_steps", 0.97), step=0.01,
                                  label="Cross replace")
            self_rep = gr.Slider(0, 1, g("self_replace_steps", 0.97), step=0.01,
                                 label="Self replace")
        with gr.Row():
            skip = gr.Slider(0, 10, 2, step=1, label="skip_steps")
            latent_rep = gr.Slider(0, 1, g("latent_replace", 0.1), step=0.01,
                                   label="Latent replace")
            opt_steps = gr.Slider(0, 1, g("optimize_steps", 0.65), step=0.01,
                                  label="Optimize steps")
            fast_opt = gr.Slider(0, 1, 0.0, step=0.01, label="Fast Optim Steps")
            focal = gr.Slider(0, 3000, 550, step=0.1, label="cam_focal_length")
        with gr.Row():
            ddim_steps = gr.Slider(25, 50, 50, step=1, label="DDIM steps")
            n_first = gr.Slider(1, 50, 1, step=1, label="Num first optim steps")
            lr = gr.Slider(0.001, 10.0, 0.03, step=0.001, label="learning rate")
            sp_radius = gr.Slider(0.0, 5.0, 1.3, step=0.01, label="splatting radius")
            sp_tau = gr.Slider(1e-3, 2.0, 1.0, step=1e-3, label="splatting tau")
            sp_ppp = gr.Slider(1, 30, 15, step=1, label="splatting points per pixel")
    with gr.Accordion("Movement Loss Control", open=False):
        with gr.Row():
            sim_self = gr.Slider(0, 1000, 55.0, step=0.001, label="Background loss (self)")
            sim_cross = gr.Slider(0, 1000, 45.0, step=0.001, label="Background loss (cross)")
            rem_self = gr.Slider(0, 1000, 2.6, step=0.01, label="loss removal_scale (self)")
            rem_cross = gr.Slider(0, 1000, 2.6, step=0.01, label="loss removal_scale (cross)")
            rem_adaptive = gr.Slider(-30.0, 0.0, -1.5, step=0.01,
                                     label="Removal Loss Adaptive Value")
        with gr.Row():
            mov_self = gr.Slider(0, 1000, 30.5, step=0.01,
                                 label="foreground preservation loss (self)")
            mov_cross = gr.Slider(0, 1000, 30.34, step=0.01,
                                  label="foreground preservation loss (cross)")
            amodal_self = gr.Slider(0, 1000, 80.5, step=0.01, label="amodal loss (self)")
            amodal_cross = gr.Slider(0, 1000, 3.5, step=0.01, label="amodal loss (cross)")
        with gr.Row():
            smooth_self = gr.Slider(0, 1000, 30.0, step=0.01,
                                    label="loss movement_smoothness (self)")
            smooth_cross = gr.Slider(0, 1000, 15.0, step=0.01,
                                     label="loss movement_smoothness (cross)")
            diff_corr = gr.Slider(0.0, 0.4, 0.1, step=0.01, label="Diffusion Correction",
                                  info="high values reduce edit adherence")
    return [
        guidance, cross_rep, self_rep, skip, latent_rep, opt_steps, fast_opt,
        n_first, ddim_steps, lr, sp_radius, sp_tau, sp_ppp, focal, diff_corr,
        rem_adaptive, sim_self, sim_cross, mov_self, mov_cross, rem_self,
        rem_cross, amodal_self, amodal_cross, smooth_self, smooth_cross,
    ]


def _adv_from_values(vals) -> cb.AdvancedOptions:
    (guidance, cross_rep, self_rep, skip, latent_rep, opt_steps, fast_opt,
     n_first, ddim_steps, lr, sp_radius, sp_tau, sp_ppp, focal, diff_corr,
     rem_adaptive, sim_self, sim_cross, mov_self, mov_cross, rem_self,
     rem_cross, amodal_self, amodal_cross, smooth_self, smooth_cross) = vals
    return cb.AdvancedOptions(
        guidance_scale=guidance, cross_replace_steps=cross_rep,
        self_replace_steps=self_rep, skip_steps=int(skip),
        latent_replace=latent_rep, optimize_steps=opt_steps,
        fast_optim_steps=fast_opt, num_first_optim_steps=int(n_first),
        num_ddim_steps=int(ddim_steps), lr=lr, splatting_radius=sp_radius,
        splatting_tau=sp_tau, splatting_points_per_pixel=int(sp_ppp),
        cam_focal_length=focal, diffusion_correction=diff_corr,
        removal_loss_adaptive_value=rem_adaptive,
        sim_loss_self=sim_self, sim_loss_cross=sim_cross,
        movement_loss_self=mov_self, movement_loss_cross=mov_cross,
        removal_loss_self=rem_self, removal_loss_cross=rem_cross,
        amodal_loss_self=amodal_self, amodal_loss_cross=amodal_cross,
        smoothness_loss_self=smooth_self, smoothness_loss_cross=smooth_cross,
    )


def build_app(checkpoint_dir=None, image_size: int = 512, device="cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use the web UI "
            "(python -m geodiffuser_tpu_torch.ui --native), the edit API "
            "(core.editor.perform_geometric_edit) or the batch driver "
            "(parallel.driver) instead"
        ) from e

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

    pipeline = Pipeline.create(ModelConfig(), image_size=image_size,
                               checkpoint_dir=checkpoint_dir, device=device)
    state = cb.UIState(pipeline=pipeline, device=str(pipeline.device))

    def on_upload(img):
        return cb.load_image(state, img)

    def on_click(img, evt: "gr.SelectData"):
        x, y = evt.index
        h, w = state.image.shape[:2]
        return cb.get_mask(state, x / w, y / h)

    def on_depth(model, translate_factor):
        return cb.get_depth(state, model, translate_factor)

    def on_preview(tx, ty, tz, rx, ry, rz, sx, sy, sz, focal):
        cb.compose_transform_from_sliders(state, tx, ty, tz, rx, ry, rz, sx, sy, sz)
        return cb.get_transformed_preview(state, focal_length=focal)

    def on_edit(prompt, *adv_vals, progress=gr.Progress()):
        return cb.get_edited_image(
            state, prompt, adv=_adv_from_values(adv_vals), progress=progress
        )

    def on_inpaint(prompt, *adv_vals, progress=gr.Progress()):
        return cb.inpaint_mask(
            state, prompt, adv=_adv_from_values(adv_vals), progress=progress
        )

    def on_save(root, category, result):
        return cb.save_experiment(state, root, category, result)

    def on_load(folder):
        exp = cb.load_experiment(state, folder)
        return exp.input_image, state.mask, state.depth

    with gr.Blocks(title="GeoDiffuser") as demo:
        with gr.Tab("Editing Real Image"):
            with gr.Row():
                inp = gr.Image(label="Input")
                mask_view = gr.Image(label="Mask (click object)")
                prev = gr.Image(label="Transformed preview")
                out = gr.Image(label="Edited")
            with gr.Row():
                depth_model = gr.Dropdown(
                    list(cb.DEPTH_MODELS), value="depth_anything", label="Depth model"
                )
                translate_factor = gr.Slider(0.0, 2.0, 0.7, label="translate factor")
                depth_view = gr.Image(label="Depth")
                depth_btn = gr.Button("Get Depth")
            with gr.Row():
                sliders = [
                    gr.Slider(-0.5, 0.5, 0.0, label=n) for n in ("tx", "ty", "tz")
                ] + [
                    gr.Slider(-90, 90, 0.0, label=n) for n in ("rx", "ry", "rz")
                ] + [
                    gr.Slider(0.5, 1.5, 1.0, label=n) for n in ("sx", "sy", "sz")
                ]
            focal = gr.Slider(100, 1000, 550, label="focal length (preview)")
            preview_btn = gr.Button("Check Transformed Image")
            prompt = gr.Textbox(label="prompt", value="")
            adv = _advanced_accordion(gr)
            edit_btn = gr.Button("Move Object")
            with gr.Row():
                exp_root = gr.Textbox(label="experiment root", value="./ui_outputs")
                exp_cat = gr.Dropdown(list(cb.CATEGORIES), value="Mix", label="category")
                save_btn = gr.Button("Save Experiment")
                load_path = gr.Textbox(label="experiment folder to load")
                load_btn = gr.Button("Load Experiment")
                saved_to = gr.Textbox(label="saved to")

            inp.upload(on_upload, inp, inp)
            inp.select(on_click, inp, mask_view)
            depth_btn.click(on_depth, [depth_model, translate_factor], depth_view)
            preview_btn.click(on_preview, sliders + [focal], prev)
            edit_btn.click(on_edit, [prompt] + adv, out)
            save_btn.click(on_save, [exp_root, exp_cat, out], saved_to)
            load_btn.click(on_load, load_path, [inp, mask_view, depth_view])

        with gr.Tab("Inpainting"):
            with gr.Row():
                inp2 = gr.Image(label="Input")
                mask_view2 = gr.Image(label="Mask (click object)")
                out2 = gr.Image(label="Inpainted")
            prompt2 = gr.Textbox(label="prompt", value="")
            adv2 = _advanced_accordion(gr, remover=True)
            inpaint_btn = gr.Button("Inpaint Mask")
            inp2.upload(on_upload, inp2, inp2)
            inp2.select(on_click, inp2, mask_view2)
            inpaint_btn.click(on_inpaint, [prompt2] + adv2, out2)

    return demo


if __name__ == "__main__":
    build_app().queue().launch()

"""Gradio web demo of the port: interactive restoration on the card.

    python -m tpuir_torch.scripts.demo

A thin Blocks shell over the handlers of ``tpuir_torch/demo_core.py`` (the
task table, the model-availability matrix, the sample gallery, the
run, select and change handlers, all testable without gradio), as
``scripts/demo.py`` is over tpuir's: task and subtask dropdowns, the model
list filtered by availability, the dataset sample gallery, optional AWGN,
patch size and overlap sliders, the device selector (each card, then the
CPU) and a before/after comparison slider.

Needs ``pip install gradio``; prints how to install it when it is absent.
"""

import sys

from tpuir_torch.demo_core import (  # noqa: F401  (re-exported for callers)
    TASKS,
    available_models,
    device_choices,
    gallery_select,
    run_restoration,
    sample_images,
    subtask_change,
)


def build_app():
    import gradio as gr
    import torch

    n = torch.cuda.device_count()
    backend = torch.cuda.get_device_name(0) if n else "CPU (no CUDA device)"
    with gr.Blocks(title="tpuir_torch — image restoration zoo") as app:
        gr.Markdown(f"# tpuir_torch demo\nDevice: **{backend}** ({n} CUDA device(s))")
        with gr.Row():
            subtask = gr.Dropdown(
                [s for subs in TASKS.values() for s in subs],
                value="Gaussian (Color, Non-blind)", label="Task / Subtask",
            )
            model = gr.Dropdown(["Restormer", "MaIR"], label="Model")
            sigma = gr.Dropdown([15, 25, 50], value=25, label="Sigma")
        with gr.Row():
            add_noise = gr.Checkbox(True, label="Add Gaussian noise to input")
            patch_size = gr.Slider(64, 2048, value=256, step=16, label="Patch size")
            patch_overlap = gr.Slider(0, 512, value=48, step=16, label="Patch overlap")
            device = gr.Dropdown(
                device_choices(), value=device_choices()[0], label="Device"
            )
        inp = gr.Image(label="Input image", type="numpy")
        gallery = gr.Gallery(label="Dataset samples", columns=6, height=140)
        sample_paths = gr.State([])
        run_btn = gr.Button("Restore", variant="primary")
        with gr.Row():
            before = gr.Image(label="Model input")
            after = gr.Image(label="Restored")
        # ImageSlider is in core gradio from v4/v5; older installs keep the
        # side-by-side row above
        compare = gr.ImageSlider(label="Compare (drag)", interactive=False) \
            if hasattr(gr, "ImageSlider") else None
        time_box = gr.Textbox(label="Inference time")

        def on_subtask(label):
            models, sigma_visible, ps, po, samples = subtask_change(label)
            return (
                gr.update(choices=models, value=models[0]),
                gr.update(visible=sigma_visible),
                gr.update(value=ps),
                gr.update(value=po),
                samples,
                samples,
            )

        subtask.change(
            on_subtask, [subtask],
            [model, sigma, patch_size, patch_overlap, gallery, sample_paths],
        )

        def on_gallery_select(paths, evt: gr.SelectData):
            return gallery_select(paths, evt.index)

        gallery.select(on_gallery_select, [sample_paths], inp)

        def do_run(image, subtask_label, model_name, sig, noise, ps, po, dev):
            before_img, after_img, ms = run_restoration(
                image, subtask_label, model_name, sig, noise, ps, po, dev
            )
            outs = [before_img, after_img, ms]
            if compare is not None:
                outs.append((before_img, after_img))
            return tuple(outs)

        run_btn.click(
            do_run,
            [inp, subtask, model, sigma, add_noise, patch_size, patch_overlap,
             device],
            [before, after, time_box] + ([compare] if compare is not None else []),
        )
    return app


def main():
    try:
        import gradio  # noqa: F401
    except ImportError:
        print(
            "gradio is not installed in this environment.\n"
            "Install it with `pip install gradio` and re-run "
            "`python -m tpuir_torch.scripts.demo`.\n"
            "The non-interactive smoke test (`python -m tpuir_torch.scripts.test_demo`) "
            "covers the same model matrix."
        )
        return 1
    build_app().launch()
    return 0


if __name__ == "__main__":
    sys.exit(main())

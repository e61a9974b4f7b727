"""`python -m geodiffuser_tpu_torch.ui` — launch the UI.

Prefers the gradio app (`ui/app.py`) when gradio is installed; otherwise,
or with --native, serves the web UI of `ui/serve.py` (the same surface).
The remaining arguments go to `ui/serve.py:main` (--device, default cuda).
"""

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    native = "--native" in argv
    if native:
        argv.remove("--native")
    if not native:
        try:
            import gradio  # noqa: F401
        except ImportError:
            native = True
    if native:
        from geodiffuser_tpu_torch.ui.serve import main as serve_main

        serve_main(argv)
        return
    from geodiffuser_tpu_torch.ui.app import build_app

    build_app().queue().launch()


if __name__ == "__main__":
    main()

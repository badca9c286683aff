"""The port's user entry points, each run as ``python -m tpuir_torch.scripts.<name>``:
``demo`` (the gradio demo), ``test_demo`` (one image a suite), ``compute_flops``,
``test_patch_size`` and ``validate_serving``."""

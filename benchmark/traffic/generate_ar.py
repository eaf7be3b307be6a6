"""DiP's autoregressive text-to-motion generation, closed loop, one client:
the generator of ``generate.py``, whose ``generate_ar`` kind continues
each prompt's prefix chunk by chunk (``MotionGenerator.generate`` with
``GenerationConfig(autoregressive=True)``)."""
from benchmark.traffic.generate import (  # noqa: F401
    check, check_request, counts, draw_inputs, end_to_end, reference_params, reference_request,
    release, request, setup, window)

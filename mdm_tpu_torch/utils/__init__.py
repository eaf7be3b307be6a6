"""Config/CLI utilities (counterpart of mdm_tpu/utils) and the port's
spans (``tracing``). Import each submodule by name: the samplers, the
models and the train step import ``tracing``, and ``factory`` imports
them."""

from . import hml_codec, quaternions  # noqa: F401

"""The port's command line (`python -m crowded_scenes_ensemble_classification_tpu_torch`)."""

from .main import build_parser, main  # noqa: F401

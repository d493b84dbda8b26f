"""The ported model families (I3D) and the registry that builds them."""

from .registry import ModelBundle, build_model, predict_proba

__all__ = ["ModelBundle", "build_model", "predict_proba"]

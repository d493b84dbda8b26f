"""The ported model families (I3D, TwoStream-I3D, C3D, R3D-18…152) and the
registry that builds them."""

from .registry import ModelBundle, build_model, predict_proba, summarize

__all__ = ["ModelBundle", "build_model", "predict_proba", "summarize"]

"""Serving export of the fused ensemble forward (`torch.export`)."""

from .export import (
    export_ensemble,
    load_serving_artifact,
    save_serving_artifact,
    serving_batch_example,
)

__all__ = ["export_ensemble", "load_serving_artifact", "save_serving_artifact", "serving_batch_example"]

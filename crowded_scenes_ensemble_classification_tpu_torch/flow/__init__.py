"""Dense optical flow on the card (Farnebäck and TV-L1).

Counterpart of `crowded_scenes_ensemble_classification_tpu/flow/`, with its
exports (`flow/__init__.py:11-31`).  Both solvers clamp each warp's
displacement to ±max_disp px (default 32), as there.  Every function takes
a flat batch of pairs (N, H, W) (or one (H, W) pair) where the JAX one
takes a pair and is vmapped.
"""

from .farneback import (  # noqa: F401
    REFERENCE_PARAMS,
    farneback_flow_batch,
    farneback_flow_clip,
    farneback_flow_pair,
    polynomial_expansion,
    rgb_to_gray,
)
from .pyramid import (  # noqa: F401
    build_pyramid,
    image_gradients,
    pyr_down,
    upsample_flow,
    warp_image,
)
from .tvl1 import (  # noqa: F401
    dequantize_flow_u8,
    quantize_flow_u8,
    tvl1_flow_clip,
    tvl1_flow_pair,
)

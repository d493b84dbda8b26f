"""Reports: confusion, difference and agreement matrices, and their PDFs."""

from .agreement import (  # noqa: F401
    agreement_histogram,
    members_correct_per_clip,
    render_agreement_pdf,
)
from .matrices import (  # noqa: F401
    CROWD11_CLASS_NAMES,
    confusion_matrix,
    difference_matrix,
    per_fold_confusions,
    render_confusion_grid_pdf,
    render_confusion_pdf,
    render_difference_pdf,
    row_normalize,
)

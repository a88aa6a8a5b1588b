"""Analysis of the port's programs without running them on the card: the
roofline of a dry-run cell (``roofline``, with the H100's constants)."""
from .roofline import (  # noqa: F401
    HW_H100,
    RooflineTerms,
    analytic_hbm_bytes,
    model_flops,
    roofline_report,
)

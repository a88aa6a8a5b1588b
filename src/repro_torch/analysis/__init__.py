"""Analysis of the port's programs without running them on the card: the
roofline of a dry-run cell (``roofline``, with the H100's constants), the
graph linter over the recorded serve paths (``lint``) and its collective
ranking (``graph_diag``)."""
from .roofline import (  # noqa: F401
    HW_H100,
    RooflineTerms,
    analytic_hbm_bytes,
    model_flops,
    roofline_report,
)

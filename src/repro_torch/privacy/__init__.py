"""Privacy risk engine: record-level risk scoring and anonymization planning
served from the mining substrate.

``risk`` turns a mining result (itemset-level quasi-identifiers) into
per-record exposure via the device coverage kernels; ``planner`` turns it
into a verified masking plan (cell suppressions + column generalizations)
with zero residual quasi-identifiers.
"""

from .planner import (
    GENERALIZED,
    MASKED,
    AnonymizationPlan,
    apply_plan,
    mine_masked,
    plan_anonymization,
    strip_masked_items,
)
from .risk import RiskProfile, risk_profile, risk_scores

__all__ = [
    "MASKED",
    "GENERALIZED",
    "AnonymizationPlan",
    "apply_plan",
    "mine_masked",
    "plan_anonymization",
    "strip_masked_items",
    "RiskProfile",
    "risk_profile",
    "risk_scores",
]

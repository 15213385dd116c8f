"""Statistical disclosure control on top of the miner: quasi-identifier
reports and the §1.1 grouping transform."""

from .quasi import (
    QuasiIdentifierReport,
    find_quasi_identifiers,
    k_anonymize_columns,
    report_as_dict,
)

__all__ = [
    "QuasiIdentifierReport",
    "find_quasi_identifiers",
    "k_anonymize_columns",
    "report_as_dict",
]

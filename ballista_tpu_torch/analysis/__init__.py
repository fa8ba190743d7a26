"""Static analysis layer.

(Reference analog: DataFusion/Spark Catalyst run an analyzer pass over
logical plans before any executor sees them — Armbrust et al., SIGMOD '15.)

* ``plan_verifier`` — rule-based invariant checks over logical plans, physical
  plans and shuffle-bounded stage graphs, run at scheduler submission time
  (error findings block the job), and EXPLAIN VERIFY's rows.
* ``concurrency`` — the runtime concurrency verifier (traced locks and
  guarded containers, off by default).

The JAX package's codebase linter and proto drift check are not ported.
"""
from ballista_tpu_torch.analysis.plan_verifier import (
    ERROR,
    Finding,
    PlanVerificationError,
    WARNING,
    errors_of,
    verify_exchange_resolution,
    verify_logical,
    verify_memory,
    verify_physical,
    verify_stages,
    verify_submission,
    warnings_of,
)

__all__ = [
    "ERROR",
    "WARNING",
    "Finding",
    "PlanVerificationError",
    "errors_of",
    "verify_exchange_resolution",
    "verify_logical",
    "verify_memory",
    "verify_physical",
    "verify_stages",
    "verify_submission",
    "warnings_of",
]

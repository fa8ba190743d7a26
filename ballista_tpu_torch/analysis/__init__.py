"""Static analysis layer.

(Reference analog: DataFusion/Spark Catalyst run an analyzer pass over
logical plans before any executor sees them — Armbrust et al., SIGMOD '15.)

* ``plan_verifier`` — rule-based invariant checks over logical plans, physical
  plans and shuffle-bounded stage graphs, run at scheduler submission time
  (error findings block the job), and EXPLAIN VERIFY's rows.
* ``concurrency`` — the runtime concurrency verifier (traced locks and
  guarded containers, off by default).
* ``lint`` — the codebase linter, the JAX package's rules whole, against the
  port's own baseline (``lint_baseline.json``, empty):
  ``python -m ballista_tpu_torch.analysis.lint ballista_tpu_torch/``.
* ``proto_drift`` — each ``proto/*.proto`` against its checked-in ``_pb2``
  module: ``python -m ballista_tpu_torch.analysis.proto_drift``.
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

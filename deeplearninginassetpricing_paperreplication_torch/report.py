"""``python -m deeplearninginassetpricing_paperreplication_torch.report`` —
aggregate run-dir telemetry into a phase/throughput/memory report, one
Chrome trace (``--trace``) and a budget gate (``--budget``).

Thin module-runner shim; the implementation lives in
:mod:`.observability.report` (pure file reading — no device touched).
"""

from .observability.report import build_arg_parser, main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())

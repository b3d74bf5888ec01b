"""``python -m deeplearninginassetpricing_paperreplication_torch.supervise`` —
run any heartbeat-writing entrypoint under hang detection, restart with
automatic ``--resume`` (or ``--resume-from-ledger``), and crash-loop
policy.

Thin module-runner shim; the implementation lives in
:mod:`.reliability.supervisor`. The supervise loop never imports torch,
and neither does this entry: the package ``__init__`` resolves its
exports lazily. When the child's stack may be wedged, run the
implementation directly instead (it loads its stdlib-only dependencies
by path):

    python deeplearninginassetpricing_paperreplication_torch/reliability/supervisor.py \\
        --run_dir ckpt -- <child command>
"""

from .reliability.supervisor import build_arg_parser, main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())

"""The port's three CLIs share one set of execution flags.

``train``, ``evaluate_ensemble``, ``sweep`` and ``serving.server`` each take
``--device``, ``--compute_dtype`` and ``--kernel auto|on|off`` through
``evaluate_ensemble.add_execution_args``, and ``execution_config`` turns
them into the ``ExecutionConfig`` the run uses: ``--kernel off`` is how a
user asks for the plain PyTorch route on a card.
"""

import pytest

from deeplearninginassetpricing_paperreplication_torch import (
    evaluate_ensemble,
    sweep,
    train,
)
from deeplearninginassetpricing_paperreplication_torch.serving import server
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)

REQUIRED = {
    "train": (train.build_arg_parser, ["--data_dir", "d"]),
    "evaluate_ensemble": (evaluate_ensemble.build_arg_parser,
                          ["--data_dir", "d", "--checkpoint_dirs", "r"]),
    "server": (server.build_arg_parser, ["--checkpoint_dirs", "r"]),
    "sweep": (sweep.build_arg_parser, ["--data_dir", "d"]),
}


@pytest.mark.parametrize("cli", sorted(REQUIRED))
def test_kernel_flag_reaches_the_execution_config(cli):
    parser, required = REQUIRED[cli]
    args = parser().parse_args(required + ["--device", "cpu", "--kernel",
                                           "off"])
    assert evaluate_ensemble.execution_config(args) == ExecutionConfig(
        kernel="off", compute_dtype="bfloat16", device="cpu")
    args = parser().parse_args(required + ["--device", "cpu"])
    assert evaluate_ensemble.execution_config(args).kernel == "auto"


@pytest.mark.parametrize("cli", sorted(REQUIRED))
def test_kernel_flag_rejects_other_values(cli, capsys):
    parser, required = REQUIRED[cli]
    with pytest.raises(SystemExit) as e:
        parser().parse_args(required + ["--kernel", "fast"])
    assert e.value.code == 2
    assert "--kernel" in capsys.readouterr().err

"""Kernels of the PyTorch port and their plain versions.

Each kernel wrapper counts its own launches (``sdf_ffn.launches``,
``bwd_launches``, ``dx_launches``; ``cond_em.fwd_launches``,
``bwd_launches``, ``dx_launches``). A process started by another — a
supervised train CLI, an elastic sweep worker — keeps its counts to
itself; with ``DLAP_LAUNCH_COUNTS`` naming a file, it appends them there
as one JSON line when it exits normally (a killed process leaves none),
so the parent that started it can read them.
"""

import atexit
import json
import os
import sys

ENV_LAUNCH_COUNTS = "DLAP_LAUNCH_COUNTS"


def _append_launch_counts(path):
    """This process's launches by kernel, from the wrappers' counters of
    the kernel modules it loaded (a module not loaded launched nothing),
    as one JSON line appended to `path`."""
    ffn = sys.modules.get(f"{__name__}.sdf_ffn")
    cem = sys.modules.get(f"{__name__}.cond_em")
    row = {
        "pid": os.getpid(), "argv": sys.argv,
        "sdf_ffn_fwd": ffn.launches if ffn else 0,
        "sdf_ffn_bwd": ffn.bwd_launches if ffn else 0,
        "sdf_ffn_dx": ffn.dx_launches if ffn else 0,
        "cond_em_fwd": cem.fwd_launches if cem else 0,
        "cond_em_bwd": cem.bwd_launches if cem else 0,
        "cond_em_dx": cem.dx_launches if cem else 0,
    }
    try:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
    except OSError:
        pass  # a count sink must never fail the process's exit


if os.environ.get(ENV_LAUNCH_COUNTS):
    atexit.register(_append_launch_counts, os.environ[ENV_LAUNCH_COUNTS])

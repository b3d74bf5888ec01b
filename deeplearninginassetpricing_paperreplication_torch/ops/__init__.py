"""Kernels of the PyTorch port and their plain versions.

Each kernel wrapper counts its own launches, per (kernel, device), through
:func:`count_launch`, where it launches and nowhere else. The module totals
(``sdf_ffn.launches``, ``bwd_launches``, ``dx_launches``;
``cond_em.fwd_launches``, ``bwd_launches``, ``dx_launches``) sum them over
the devices; :func:`device_launch_counts` reads one device's. A process
started by another — a supervised train CLI, an elastic sweep worker —
keeps its counts to itself; with ``DLAP_LAUNCH_COUNTS`` naming a file, it
appends them there as one JSON line when it exits normally (a killed
process leaves none), so the parent that started it can read them.

A launch on a bf16 panel (``ExecutionConfig.bf16_panel``) also counts
under its kernel's bf16-panel form, ``<kernel>_bf16_panel``
(:data:`BF16_PANEL_KERNELS`), so a run can show which form its path took.
Likewise a launch of an FFN kernel's streamed-weight route (the stacks its
resident route cannot hold) also counts under ``<kernel>_stream``
(:data:`STREAM_KERNELS`), and one of that route's tensor-core form (bf16
compute) also under ``<kernel>_stream_mma`` (:data:`STREAM_MMA_KERNELS`),
and one of its register-tiled form (f32 compute) also under
``<kernel>_stream_tiled`` (:data:`STREAM_TILED_KERNELS`).
"""

import atexit
import json
import os
import sys
import threading
from typing import Dict, Iterable, Tuple

ENV_LAUNCH_COUNTS = "DLAP_LAUNCH_COUNTS"
KERNELS = ("sdf_ffn_fwd", "sdf_ffn_bwd", "sdf_ffn_dx", "cond_em_fwd",
           "cond_em_bwd", "cond_em_dx")
BF16_PANEL = "_bf16_panel"
BF16_PANEL_KERNELS = tuple(k + BF16_PANEL for k in KERNELS)
STREAM = "_stream"
STREAM_KERNELS = tuple(k + STREAM for k in KERNELS[:3])
STREAM_MMA = "_stream_mma"
STREAM_MMA_KERNELS = tuple(k + STREAM_MMA for k in KERNELS[:3])
STREAM_TILED = "_stream_tiled"
STREAM_TILED_KERNELS = tuple(k + STREAM_TILED for k in KERNELS[:3])


# (kernel, device) -> launches, under one lock: a server launches from its
# dispatch thread while another thread may reload
_launch_counts: Dict[Tuple[str, str], int] = {}
_launch_lock = threading.Lock()


def count_launch(kernel: str, device) -> None:
    """One launch of `kernel` on `device`."""
    if (kernel not in KERNELS and kernel not in BF16_PANEL_KERNELS
            and kernel not in STREAM_KERNELS
            and kernel not in STREAM_MMA_KERNELS
            and kernel not in STREAM_TILED_KERNELS):
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS} (or "
                         f"its bf16-panel or streamed form)")
    key = (kernel, str(device))
    with _launch_lock:
        _launch_counts[key] = _launch_counts.get(key, 0) + 1


def launch_total(kernel: str) -> int:
    """The launches of `kernel` on every device."""
    with _launch_lock:
        return sum(n for (k, _), n in _launch_counts.items() if k == kernel)


def reset_launch_counts(kernels: Iterable[str]) -> None:
    """Set the counts of `kernels` to 0 on every device."""
    kernels = set(kernels)
    with _launch_lock:
        for key in [k for k in _launch_counts if k[0] in kernels]:
            del _launch_counts[key]


def device_launch_counts(device) -> Dict[str, int]:
    """{kernel: launches on `device`} of the six training and serving
    kernels."""
    with _launch_lock:
        return {k: _launch_counts.get((k, str(device)), 0) for k in KERNELS}


def _append_launch_counts(path):
    """This process's launches by kernel as one JSON line appended to
    `path`."""
    row = {"pid": os.getpid(), "argv": sys.argv,
           **{k: launch_total(k)
              for k in KERNELS + STREAM_KERNELS + STREAM_MMA_KERNELS
              + STREAM_TILED_KERNELS}}
    try:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
    except OSError:
        pass  # a count sink must never fail the process's exit


if os.environ.get(ENV_LAUNCH_COUNTS):
    atexit.register(_append_launch_counts, os.environ[ENV_LAUNCH_COUNTS])

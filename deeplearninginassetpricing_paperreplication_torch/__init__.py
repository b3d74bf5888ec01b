"""Deep Learning Asset Pricing in PyTorch, for one NVIDIA H100.

The PyTorch port of ``deeplearninginassetpricing_paperreplication_tpu``,
module for module under the same names. It imports no JAX: the JAX package
is the reference the port is held against, in the tests only.

Entry points run on the CUDA device unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``). On the card the SDF network's FFN
runs in the hand-written kernel ``ops/csrc/sdf_ffn.cu``; on the CPU it runs
the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

# the data plane's public names and the joint trainers', as the JAX package
# exports them; resolved at first use, so importing a stdlib-only module of
# the package (the promotion gate, the fault injector) does not import torch
_EXPORTS = {
    "PanelDataset": "data.panel", "load_panel": "data.panel",
    "load_splits": "data.panel", "StartupPipeline": "data.pipeline",
    "load_splits_cached": "data.pipeline",
    "load_splits_chunked": "data.pipeline", "stream_batch": "data.pipeline",
    "stream_batch_sharded": "data.pipeline",
    "generate_all_splits": "data.synthetic",
    "generate_dataset": "data.synthetic",
    "SimpleSDF": "models.networks", "joint_train": "training.joint",
    "train_simple_sdf": "training.joint",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)

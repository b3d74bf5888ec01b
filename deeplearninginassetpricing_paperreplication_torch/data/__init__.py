"""Panel data: the synthetic generator, the .npz loader with its native
codec, the decoded-panel disk cache, the mask-packed transfer and the
overlapped startup pipeline."""

# the public names, resolved at first use (importing a numpy-only module of
# this package, such as diskcache or native, does not import torch)
_EXPORTS = {
    "PanelDataset": "panel", "load_panel": "panel", "load_splits": "panel",
    "StartupPipeline": "pipeline", "load_splits_cached": "pipeline",
    "load_splits_chunked": "pipeline", "stream_batch": "pipeline",
    "stream_batch_sharded": "pipeline",
    "generate_all_splits": "synthetic", "generate_dataset": "synthetic",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)

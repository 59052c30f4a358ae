"""Graph-construction pipeline of the port: slide tiling, the in-memory
tissue extractor, patch loading, slide-to-graph construction on the
device, train/val/test splits.

Names load lazily from their modules, so a spawned tiling worker that
imports `pipeline.tiler` does not import torch with `construct`."""
from importlib import import_module

_EXPORTS = {
    "GraphConstructor": "construct", "build_default_encoder": "construct",
    "construct_all": "construct", "make_encoder": "construct",
    "random_encoder": "construct",
    "iter_patch_batches": "patches", "list_patches": "patches",
    "load_patch": "patches",
    "generate_splits": "splits", "write_split_lists": "splits",
    "Extractor": "extractor",
    "DeepZoomStaticTiler": "tiler", "PilDeepZoom": "tiler",
    "nested_patches": "tiler", "tile_slides": "tiler",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)

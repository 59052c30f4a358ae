"""Graph-construction pipeline of the port: patch loading, slide-to-graph
construction on the device, train/val/test splits."""
from .construct import (GraphConstructor, build_default_encoder,
                        construct_all, make_encoder, random_encoder)
from .patches import iter_patch_batches, list_patches, load_patch
from .splits import generate_splits, write_split_lists

__all__ = ["GraphConstructor", "build_default_encoder", "construct_all",
           "generate_splits", "iter_patch_batches", "list_patches",
           "load_patch", "make_encoder", "random_encoder",
           "write_split_lists"]

"""mx.kvstore on one card: the plugin base and registry, ``TestStore``,
the single-process ``KVStore`` ("local", "device", "nccl") and 1-bit /
2-bit gradient compression. The ``dist_*`` stores, Horovod / BytePS and
the server module wait for the multi-card slice (ROADMAP.md Queue 1,
item 8): ``create("dist_*")`` raises."""
from .base import KVStoreBase, TestStore, create
from .gradient_compression import GradientCompression, pack_codes, \
    unpack_codes
from .kvstore import KVStore

__all__ = ["KVStoreBase", "TestStore", "KVStore", "create",
           "GradientCompression", "pack_codes", "unpack_codes"]

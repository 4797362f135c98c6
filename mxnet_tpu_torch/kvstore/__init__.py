"""mx.kvstore: the plugin base and registry, ``TestStore``, the
single-process ``KVStore`` ("local", "device", "nccl"), 1-bit / 2-bit
gradient compression, the distributed stores ("dist_sync",
"dist_device_sync", "dist_async") over the process group, the Horovod /
BytePS plugins and the server-role pointer."""
from .base import KVStoreBase, TestStore, create
from .gradient_compression import GradientCompression, pack_codes, \
    unpack_codes
from .kvstore import KVStore
from .dist import CollectiveTimeout, DistAsyncKVStore, DistKVStore
from .horovod import BytePS, Horovod
from .kvstore_server import KVStoreServer, init_server_module

__all__ = ["KVStoreBase", "TestStore", "KVStore", "create",
           "GradientCompression", "pack_codes", "unpack_codes",
           "CollectiveTimeout", "DistKVStore", "DistAsyncKVStore",
           "Horovod", "BytePS", "KVStoreServer", "init_server_module"]

# a process launched with DMLC_ROLE=server fails fast at import with the
# pointer (the reference runs _init_kvstore_server_module at import)
init_server_module()

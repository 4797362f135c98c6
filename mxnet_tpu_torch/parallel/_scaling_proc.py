"""One rank of the scaling harness (``parallel/scaling.py``), started by
``tools/launch.py``: ``python -m mxnet_tpu_torch.parallel._scaling_proc
--proc weak|overhead``."""
from mxnet_tpu_torch.parallel.scaling import _main

if __name__ == "__main__":
    _main()

# fp8 kernel times (phase 10) in each tree, alone and after that tree's
# phase 2e (the int8 kernel's cases), in turns base, change, change, base.
# Usage: chip_ab/base and chip_ab/change as for final_ab.sh, then
#   bash tools/ab/fp8_ctx.sh
R=$PWD
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for mode in alone after2e; do
for t in base change change base; do
  (cd "$R/chip_ab/$t" && python3 -c "
import torch, chip_smoke as cs
from mxnet_tpu_torch import _native
_native.build(['fp8_matmul', 'int8_matmul'])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)
if '$mode' == 'after2e':
    cs.phase_int8_vs_plain(dev)
cs.phase_fp8_times(dev, '$t $mode')
") 2>&1 | grep "fp8_matmul (M" | python3 -c "
import sys, json
for l in sys.stdin:
    tag, d = l.split(': ', 1); d = json.loads(d)
    print(tag[:60], round(d['kernel_device_ms'], 5), 'prepare', round(d['prepare_device_ms'], 5))"
done; done

# fp8 kernel times (chip_smoke.py phase 10) of the parent tree (chip_ab/base)
# and of this tree, in turns: base, change, change, base.
# Usage: chip_ab/base as for final_ab.sh; then bash tools/ab/fp8_ab.sh
R=$PWD
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for t in base change change base; do
  d="$R/chip_ab/base"; [ $t = change ] && d="$R"
  (cd "$d" && python3 -c "
import torch, chip_smoke as cs
from mxnet_tpu_torch import _native
_native.build(['fp8_matmul'])
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_fp8_times(torch.device('cuda', 0), '$t')
") 2>&1 | grep "fp8_matmul (M"
done

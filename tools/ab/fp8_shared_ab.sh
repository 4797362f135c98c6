# chip_smoke.py of this tree (chip_ab/change) against the same tree with
# the parent's fp8_matmul.cu (its own GEMM, chip_ab/oldfp8), in turns change,
# oldfp8, oldfp8, change; prints phase 10 (kernel 7) of each run.
# Usage: chip_ab/change as for final_ab.sh; chip_ab/oldfp8 a copy of it
# with the parent's mxnet_tpu_torch/csrc/fp8_matmul.cu (git show
# <parent>:mxnet_tpu_torch/csrc/fp8_matmul.cu); then
#   bash tools/ab/fp8_shared_ab.sh
R=$PWD
OUT=${OUT:-$R/chip_ab/out}  # where each run's full output goes
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for t in change oldfp8 oldfp8 change; do
  i=$((i+1))
  (cd "$R/chip_ab/$t" && python3 chip_smoke.py > "$OUT/sh_${i}_$t.txt" 2>&1)
  echo "$i $t rc=$?"
  grep "fp8_matmul (M" "$OUT/sh_${i}_$t.txt" | python3 -c "
import sys, json
for l in sys.stdin:
    tag, d = l.split(': ', 1); d = json.loads(d)
    print(tag[:40], round(d['kernel_device_ms'], 5), 'prepare', round(d['prepare_device_ms'], 5))"
done

# The parent tree (chip_ab/base) against this tree (chip_ab/change, from git
# archive): chip_smoke.py in turns base, change, change, base; then the
# card tests on the change tree.
# Usage, from the repository root on a machine with the card:
#   git archive <parent> | tar -x -C chip_ab/base      (chip_ab/ is ignored)
#   git archive $(git write-tree) | tar -x -C chip_ab/change
#   bash tools/ab/final_ab.sh
R=$PWD
OUT=${OUT:-$R/chip_ab/out}  # where each run's full output goes
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
i=0
for t in base change change base; do
  i=$((i+1))
  (cd "$R/chip_ab/$t" && python3 chip_smoke.py > "$OUT/ab_${i}_$t.txt" 2>&1)
  echo "$i $t rc=$?"; tail -n 1 "$OUT/ab_${i}_$t.txt" | cut -c1-200
  grep "total seconds" "$OUT/ab_${i}_$t.txt"
done
(cd "$R/chip_ab/change" && timeout 700 python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py -q > "$OUT/ab_cards.txt" 2>&1)
echo "cards rc=$?"; tail -n 1 "$OUT/ab_cards.txt"

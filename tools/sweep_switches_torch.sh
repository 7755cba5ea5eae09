#!/bin/bash
# Full-test-set quality of the PyTorch/CUDA port's render switches: each
# geometry-table switch value (render/demo.py GEOMETRY_SWITCHES, as
# chip_smoke.py's phase 3g renders them in the fast mode), the windowed tap
# without splat bins, and the global sigma compaction at the shipped cap and
# at quality_sweep.py's 524288; each a tools/quality_sweep_torch.py run. The
# summary JSON line of each goes to artifacts/sweep_switches_torch.jsonl.
# Extra arguments (e.g. `device cpu`) are passed to every run.
#   bash tools/sweep_switches_torch.sh
set -u
OUT=artifacts/sweep_switches_torch.jsonl
EXTRA=("$@")
: > "$OUT"
run() {
  name="$1"; shift
  echo "== $name: $*" >&2
  line=$(timeout 2400 python -u tools/quality_sweep_torch.py "$@" "${EXTRA[@]}" 2>/dev/null | tail -1)
  echo "{\"switch\": \"$name\", \"result\": $line}" >> "$OUT"
  echo "$line" >&2
}
run coarse_nearest_1 tpu.coarse_nearest 1
run coarse_nearest_0 tpu.coarse_nearest 0
run fold_coarse_fc_off tpu.fold_coarse_fc False
run merge_coarse_octet_off tpu.merge_coarse_octet False
run l1_nearest_1 tpu.l1_nearest 1
run l1_nearest_2 tpu.l1_nearest 2
run l1_nearest_11 tpu.l1_nearest 11
run int4_coarse tpu.int4_coarse True
run pack_octet_u32 tpu.pack_octet_u32 True
run dense_conv tpu.dense_conv True
run quantize_volume_off tpu.quantize_volume False
run window_no_bins tpu.splat_bins False tpu.tap_window 32
run compacted tpu.dense_slots False
run compacted_524288 tpu.dense_slots False tpu.sigma_cap 524288

#!/usr/bin/env bash
# Pre-merge smoke gate of the PyTorch/CUDA port (src/repro_torch): every leg
# of scripts/smoke.sh, in its order, through the port's launchers at the
# same small sizes. Each `--devices N` of that script is a ring of N
# processes under torchrun: gloo on the CPU; on one card the N processes
# share it (--share-cards: gloo, the collectives staged through host
# memory, since NCCL refuses two ranks on one card).
#
#   bash scripts/smoke_torch.sh                     # on the card
#   SMOKE_DEVICE=cpu bash scripts/smoke_torch.sh    # on the CPU
#
# Left out: the perf-gate leg (benchmarks/run.py --check against the
# committed BENCH_*.json), which waits for the port's own benchmark.
# Nothing is written into the repo: every output goes to a temp directory.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
DEVICE=${SMOKE_DEVICE:-cuda}
SHARE=()
[ "$DEVICE" = cpu ] || SHARE=(--share-cards)
LEGS=scripts/smoke_torch_legs.py
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
SECONDS=0

# ring N ARGS...: ARGS under torchrun on N processes of this machine
ring() {
  local n=$1
  shift
  python -m torch.distributed.run --standalone --nproc-per-node "$n" "$@"
}
train() { ring "$1" -m repro_torch.launch.train --device "$DEVICE" "${SHARE[@]}" "${@:2}"; }
serve() { ring "$1" -m repro_torch.launch.serve --device "$DEVICE" "${SHARE[@]}" "${@:2}"; }
legs() { ring "$1" "$LEGS" --device "$DEVICE" "${@:2}"; }

if [ "$DEVICE" != cpu ]; then
  # one build before the first leg: 16 processes' first uses at once
  # would each compile every kernel
  echo "=== build the CUDA kernels ==="
  python -c "from repro_torch.kernels import build; build.build_all()"
fi

echo "=== a. docs check (JAX references + repro_torch references) ==="
python scripts/check_docs.py
python scripts/check_docs_torch.py

for head in full knn selective mach sampled csoft; do
  lr=2.0
  case "$head" in
    mach|csoft) lr=0.3 ;;   # raw-logit bucket CE wants a cooler LR
  esac
  echo "=== b. paper / $head head / ring of 8 ==="
  train 8 --system paper --head "$head" --classes 512 --steps 8 \
      --batch 32 --lr "$lr"
done

# the backend legs: the port's default is the kernels (--backend kernel,
# the legs above), so these run the plain versions and must train and
# serve the same heads
for head in full knn; do
  echo "=== c. paper / $head head / ref backend ==="
  train 8 --system paper --head "$head" --backend ref --classes 512 \
      --steps 4 --batch 32 --lr 2.0
done
for backend in kernel ref; do
  echo "=== c. paper / top-5 serve / $backend backend ==="
  serve 8 --system paper --classes 512 --head full --batch 16 --topk 5 \
      --backend "$backend"
done

echo "=== d. resilience / kill-and-resume (full + knn) / ring of 8 ==="
legs 8 resilience "$TMP/resilience"

echo "=== e. elastic / 8-member ckpt -> 4 and 16 members + serve parity ==="
legs 8 elastic-save "$TMP/elastic"
for n in 4 16; do
  legs "$n" elastic-restore "$TMP/elastic"
done
echo "=== e. elastic / launcher --resume-reshard continuation (8 -> 4) ==="
train 8 --system paper --head full --classes 256 --feat-dim 32 --steps 4 \
    --batch 16 --lr 2.0 --ckpt-dir "$TMP/launch" --ckpt-every 4
train 4 --system paper --head full --classes 256 --feat-dim 32 --steps 8 \
    --batch 16 --lr 2.0 --ckpt-dir "$TMP/launch" --ckpt-every 4 \
    --resume-reshard

echo "=== f. serving tier / load replay (full top-5 + csoft greedy) ==="
replays=()
for head in full csoft; do
  topk=5
  [ "$head" = full ] || topk=0
  for cache in 0 1024; do
    out="$TMP/replay_${head}_${cache}.jsonl"
    serve 8 --system paper --classes 256 --head "$head" --topk "$topk" \
        --batch 8 --replay 0.4 --cache "$cache" --metrics-out "$out"
    tag=$out
    [ "$cache" = 0 ] || tag=$out:cached
    replays+=("$tag")
  done
done
python "$LEGS" check-replay "${replays[@]}"

echo "=== g. telemetry / trace + metrics emission ==="
train 8 --system paper --head full --classes 256 --steps 5 --batch 16 \
    --trace-out "$TMP/trace.json" --metrics-out "$TMP/metrics.jsonl"
python "$LEGS" check-telemetry "$TMP"

echo "=== h. serving tier / IVF index (full + knn, ref + kernel) ==="
legs 8 ivf

# the zoo on a (2, 4) grid of 8 (launch.mesh.default_grid): the default
# full head plus the two newest registry heads
for head in full sampled csoft; do
  echo "=== i. zoo / smollm_135m (reduced) train / $head head / grid of 8 ==="
  train 8 --system zoo --arch smollm_135m --reduced --head "$head" \
      --steps 4 --batch 16 --seq 32 --lr 0.5
done

echo "=== j. zoo / smollm_135m (reduced) serve / grid of 8 ==="
serve 8 --system zoo --arch smollm_135m --reduced --prompt-len 16 --gen 8 \
    --batch 4

echo "smoke OK on $DEVICE in ${SECONDS} s"

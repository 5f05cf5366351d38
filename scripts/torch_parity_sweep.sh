#!/bin/bash
# The port's H100 parity sweep (ROADMAP.md's main-path done condition):
# three PPO seeds at 16 lanes to 1.2M steps and the DQN pairing curve
# (64 lanes, 2M steps, seed 1), each with `python -m safelife_tpu_torch
# train`, in strict float32 (the default).
#
#   bash scripts/torch_parity_sweep.sh rate          # the 16-lane rate
#   bash scripts/torch_parity_sweep.sh seeds 4e4     # seeds 1-3 to 40,960
#   bash scripts/torch_parity_sweep.sh seeds 6e5 dqn # ... and DQN to 2M
#   bash scripts/torch_parity_sweep.sh seeds 1.2e6   # seeds to 1.2M
#
# from the root of a checkout on a host with one CUDA card. The run
# directories live under runs/ (git-ignored); a rerun into the same
# directory resumes from its latest checkpoint. Each step writes its
# logs and wall times (milliseconds) to $SWEEP_OUT (runs/sweep unless
# set) and copies each run's logs and latest checkpoint, enough to
# resume, to $SWEEP_OUT/runs: on a machine whose work comes back through
# one directory, point SWEEP_OUT into it and put $SWEEP_OUT/runs/<run>
# back under runs/ before the next step. A step that ends early loses
# what it had not copied out, so each step ends on a checkpoint, and DQN
# (whose replay a resume re-warms) runs whole in one step. Then snapshot
# and compare on any host:
#   python scripts/snapshot_run.py $SWEEP_OUT/runs/torch-s1 parity/torch-s1
#   python scripts/parity_curves.py --ref results/parity/refppo-s* \
#       --ours results/parity/torch-s* --markdown
set -u
OUT=${SWEEP_OUT:-runs/sweep}
mkdir -p "$OUT/runs" runs
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee -a "$OUT/gpu.txt"

now_ms() { date +%s%3N; }

# train NAME STEPS [ARGS...]: one trainer run into runs/NAME, its output
# appended to $OUT/NAME.log and its wall time to $OUT/times.txt.
train() {
    name=$1; steps=$2; shift 2
    t0=$(now_ms)
    OMP_NUM_THREADS=2 timeout -k 10 2400 python -m safelife_tpu_torch \
        train "runs/$name" -e append-still --steps "$steps" \
        --skip-benchmark "$@" >> "$OUT/$name.log" 2>&1
    echo "$name to $steps rc=$? wall_ms=$(( $(now_ms) - t0 ))" \
        >> "$OUT/times.txt"
}

# seeds STEPS [dqn]: the three seeds (and DQN with `dqn`) as parallel
# processes; each is host-bound, and they share the card.
seeds() {
    steps=$1; with_dqn=${2:-}
    t0=$(now_ms)
    pids=""
    for s in 1 2 3; do
        train "torch-s$s" "$steps" --batch 16 --algo ppo --seed "$s" &
        pids="$pids $!"
    done
    if [ -n "$with_dqn" ]; then
        train torch-dqn-s1 2e6 --algo dqn --seed 1 &
        pids="$pids $!"
    fi
    wait $pids
    echo "side by side to $steps wall_ms=$(( $(now_ms) - t0 ))" \
        >> "$OUT/times.txt"
}

case "${1:-}" in
    rate)
        train p16 2e4 --batch 16 --seed 1
        train dqn64 2e4 --algo dqn --seed 1
        runs="p16 dqn64" ;;
    seeds)
        seeds "$2" "${3:-}"
        runs="torch-s1 torch-s2 torch-s3${3:+ torch-dqn-s1}" ;;
    *)
        echo "usage: $0 rate | seeds STEPS [dqn]" >&2
        exit 2 ;;
esac
cat "$OUT/times.txt"
# The logs and the latest checkpoint of each run (enough to resume), not
# every kept checkpoint: a run directory is copied out after every step.
for r in $runs; do
    rm -rf "$OUT/runs/$r"
    mkdir -p "$OUT/runs/$r/checkpoints"
    find "runs/$r" -maxdepth 1 -type f -exec cp {} "$OUT/runs/$r/" \;
    last=$(ls "runs/$r/checkpoints" | sed -n 's/^ckpt-\([0-9]*\)\.pt$/\1/p' \
        | sort -n | tail -1)
    cp "runs/$r/checkpoints/ckpt-$last.pt" \
        "runs/$r/checkpoints/extra-$last.json" \
        "$OUT/runs/$r/checkpoints/"
done
du -sh "$OUT"

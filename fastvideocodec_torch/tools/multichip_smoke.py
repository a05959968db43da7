"""The multi-device layer on the card: ``chip_smoke.py``'s phases 69-70,
also runnable alone on a CUDA card.

    python -m fastvideocodec_torch.tools.multichip_smoke

69. The dry run (``tools/dryrun_multichip.py 4 --device cuda --steps 2``,
    a subprocess killed at DRY_TIMEOUT s): 4 ranks over gloo
    time-sharing the card, each of the four halves one training step on a
    mesh at full width, held against the same step in one process under
    deterministic cuDNN: the loss within DRY_LOSS_REL (JAX's dry run's
    bar, ``__graft_entry__.py:121``), each gradient within DRY_GRAD_REL of
    its max (``chip_smoke.py`` phases 46 and 49's card bar), the ranks'
    parameters bit for bit equal, no plain warp or vjp, each rank's warp
    launches those of the calls it holds rows of, and in the data parallel
    halves the ranks' launches summing to one process's. The
    single-process step's gap to itself stands beside each.
70. A world of one over NCCL on cuda:0, in this process: the data parallel
    halves of LSVC-TPU and SSF-TPU (4 clips of 7 x 256x256) on a mesh of
    one rank against the unsharded step, under deterministic cuDNN. The
    loss bit for bit. SSF-TPU's step is bit-reproducible (no warp of it
    takes an image gradient), so its parameters must equal the unsharded
    step's bit for bit. LSVC-TPU's MC warp sums its image gradient by
    atomicAdd (``warp.cu:836``): its unsharded step differs from itself by
    about 2e-5 of a gradient's max, so its parameters are held within
    2 lr + 1e-6 (phase 46's bar) and its gradients within DRY_GRAD_REL.

The sharded ms are 4 processes sharing one card and its host: not a
scaling number.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time

import torch

from fastvideocodec_torch.tools import dryrun_multichip as dm

DRY_RANKS, DRY_STEPS, DRY_TIMEOUT = 4, 2, 240
DRY_LOSS_REL, DRY_GRAD_REL = dm.LOSS_REL, dm.GRAD_REL
DATA_PARALLEL_HALVES = ("lsvc_dp", "ssf_dp")


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"multichip smoke failed: {msg}")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: {time.perf_counter() - t0:.3f} s")


def dry_run_phase(out: dict, launches: dict, smi: str) -> None:
    rc, text, dry = dm.launch_on_card(DRY_RANKS, DRY_TIMEOUT, DRY_STEPS)
    if dry is None:
        log(text[-6000:])
    require(dry is not None, f"the dry run wrote no report (exit code {rc})")
    rows = {}
    for name, row in dry["halves"].items():
        ranks = row["launches_by_rank"]
        summed = {}
        for r in ranks:
            for k, v in r.items():
                summed[k] = summed.get(k, 0) + v
        launches[f"multichip_{name}"] = summed
        rerun = row["rerun"]
        log(f"{name} ({smi}): loss sharded {row['loss']:.6f} single {row['loss_ref']:.6f} "
            f"(rel {row['loss_rel']:.2e}, bar {DRY_LOSS_REL}); worst gradient gap "
            f"{row['grad_gap']:.3e} at {row['grad_gap_at']} (bar {DRY_GRAD_REL}; the "
            f"single-process step against itself {rerun['grad_gap']:.3e}); parameters "
            f"{row['param_abs']:.2e} max abs; ranks identical {row['identical']}; ms/step "
            f"sharded (rank 0) {row['ms_sharded_median']:.3f}, single "
            f"{row['ms_single_median']:.3f}; launches by rank {ranks} (single "
            f"{row['launches_single']}); plain calls {row['plain_calls']}")
        require(row["loss_rel"] <= DRY_LOSS_REL, f"dry run {name}: loss {row['loss_rel']}")
        require(row["grad_gap"] <= DRY_GRAD_REL,
                f"dry run {name}: gradient {row['grad_gap']} at {row['grad_gap_at']}")
        require(row["identical"], f"dry run {name}: the ranks' parameters differ")
        require(not any(row["plain_calls"]), f"dry run {name}: plain warps")
        require(ranks == row["want_launches_by_rank"] and
                row["launches_single"] == row["want_launches_single"],
                f"dry run {name}: launches {ranks}, want {row['want_launches_by_rank']}")
        if name in DATA_PARALLEL_HALVES:
            require(summed == row["launches_single"],
                    f"dry run {name}: the ranks' launches {summed} against one process's")
        require(not row["blocked_modules"], f"dry run {name}: {row['blocked_modules']}")
        require(not row["failed"], f"dry run {name}: {row['failed']}")
        rows[name] = {
            "loss_sharded": row["loss"], "loss_single": row["loss_ref"],
            "loss_rel": row["loss_rel"], "grad_gap": row["grad_gap"],
            "grad_gap_at": row["grad_gap_at"], "worst_grads": row["worst_grads"],
            "single_rerun_grad_gap": rerun["grad_gap"], "param_abs": row["param_abs"],
            "ms_sharded_rank0": row["ms_sharded_median"], "ms_single": row["ms_single_median"],
            "ms_sharded_by_rank": row["ms_sharded_by_rank"], "ms_single_steps": row["ms_single"],
            "enqueue_ms_by_rank": row["enqueue_ms_by_rank"],
            "launches_by_rank": ranks, "launches_single": row["launches_single"]}
    require(set(rows) == set(dm.HALVES), f"dry run halves {sorted(rows)}")
    out["halves"], out["dry_run_seconds"] = rows, dry["seconds"]


def nccl_phase(out: dict, launches: dict, smi: str) -> None:
    out["nccl_world_of_one"] = {}
    for half in DATA_PARALLEL_HALVES:
        res = dm.nccl_world_of_one(half)
        gaps, rerun, mine, ref = res["gaps"], res["rerun"], res["sharded"], res["reference"]
        exact = rerun["grad_gap"] == 0 and rerun["param_abs"] == 0
        log(f"nccl world of one, {half} ({smi}): loss {gaps['loss']:.6f} single "
            f"{gaps['loss_ref']:.6f}; gradient gap {gaps['grad_gap']:.3e} at "
            f"{gaps['grad_gap_at']}, parameters {gaps['param_abs']:.3e} max abs; the "
            f"single-process step against itself {rerun['grad_gap']:.3e} and "
            f"{rerun['param_abs']:.3e} (bit-reproducible: {exact}); launches "
            f"{mine['launches']} (single {ref['launches']}); ms/step {mine['ms']} (single "
            f"{ref['ms']})")
        require(gaps["loss_rel"] == 0, f"nccl {half}: loss {gaps['loss']} {gaps['loss_ref']}")
        if half == "ssf_dp":
            require(exact and gaps["grad_gap"] == 0 and gaps["param_abs"] == 0,
                    f"nccl {half}: not bit for bit ({gaps}, rerun {rerun})")
        else:
            require(gaps["grad_gap"] <= DRY_GRAD_REL and gaps["param_abs"] <= 2 * dm.LR + 1e-6,
                    f"nccl {half}: {gaps}")
        require(mine["launches"] == mine["want_launches"] and
                ref["launches"] == ref["want_launches"], f"nccl {half}: launches")
        require(not mine["plain_calls"] and not ref["plain_calls"], f"nccl {half}: plain warps")
        launches[f"nccl_world_of_one_{half}"] = mine["launches"]
        out["nccl_world_of_one"][half] = {
            "loss": gaps["loss"], "loss_single": gaps["loss_ref"], "grad_gap": gaps["grad_gap"],
            "param_abs": gaps["param_abs"], "single_rerun_grad_gap": rerun["grad_gap"],
            "single_rerun_param_abs": rerun["param_abs"], "bit_for_bit": exact,
            "ms": mine["ms"], "ms_single": ref["ms"], "launches": mine["launches"]}


def run(smi: str = "") -> dict:
    """Phases 69-70 on the CUDA card, its kernels built. Returns the
    numbers, the launch counts of one step by path, summed over the ranks
    (``launches``), among them."""
    out = {"note": f"{DRY_RANKS} ranks time-sharing one card over gloo: the sharded ms are the "
                   "card and host shared by the ranks, not a scaling number",
           "card": smi, "launches": {}}
    with phase(f"multi-device dry run: {DRY_RANKS} gloo ranks time-sharing the card, the four "
               f"halves at full width, {DRY_STEPS} steps each, deterministic cuDNN"):
        dry_run_phase(out, out["launches"], smi)
    with phase("nccl world of one: lsvc-tpu and ssf-tpu data parallel, 4 x 7 x 256x256 f32, "
               "deterministic cuDNN"):
        nccl_phase(out, out["launches"], smi)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("multichip_smoke needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from fastvideocodec_torch.ops.kernels import build

    build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"multi_device": run(smi)}, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

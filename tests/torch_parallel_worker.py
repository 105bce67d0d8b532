"""One rank of the port's data-, expert- and weight-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_expert_parallel.py,
tests/test_torch_weight_parallel.py).

    python tests/torch_parallel_worker.py <rank> <world> <job.pkl>

The job (a pickled dict made by the test) holds the group's port and a
list of scenarios, each {"name", "kind", ...}. The worker joins a gloo
group on the CPU through ``switch_nerf_torch.parallel.init_distributed``
(torchrun's variables set from its arguments), runs the scenarios in order
and writes its results to ``<job>.rank<rank>.pkl``. It imports torch and
the port only, never JAX.
"""
import contextlib
import datetime
import os
import pickle
import signal
import sys
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from switch_nerf_torch import parallel  # noqa: E402


@contextlib.contextmanager
def count_drops():
    """[dropped, routed] tokens of every MoE routing call in the block
    (the forward's: a remat recompute replays the same plan)."""
    from switch_nerf_torch import remat
    from switch_nerf_torch.models import moe as tmoe
    real = tmoe.extract_critical
    tally = [0, 0]

    def run(gates, *a, **k):
        plan, l_aux = real(gates, *a, **k)
        if not remat.recomputing():
            tally[0] += int((plan.locations >= plan.capacity).sum())
            tally[1] += plan.locations.numel()
        return plan, l_aux
    tmoe.extract_critical = run
    try:
        yield tally
    finally:
        tmoe.extract_critical = real


def params_of(state):
    return [p.detach().cpu().numpy().copy() for p in state.parameters()]


def train(rank, h, kill=None, poison=None, record=False, drops=False,
          refused=False, layout=False, quiet_noise=False, **_):
    """train.main on this rank, every train step's (averaged) metrics
    recorded. kill = (rank, step): that rank alone raises SIGTERM from
    inside that step. poison = (rank, call): that rank's loss terms are
    NaN at that call of the step. record: the tensors each step trained
    on. drops: count the MoE calls' dropped tokens. refused: the run must
    raise ValueError, whose message is returned. layout: this rank's own
    parts of the final parameters and moments (``bridge.local_state``),
    and the weight gathers made. quiet_noise: the MoE layers' gate noise
    draws are zeros (the JAX side of the test draws zeros too)."""
    from switch_nerf_torch import runner as trunner
    from switch_nerf_torch import train as ttrain
    from switch_nerf_torch.parallel import weights
    metrics, batches, worlds = [], [], []
    before = dict(weights.STATS)
    real_make = trunner.make_train_step

    def make(*a, **k):
        step = real_make(*a, **k)
        real_lg = step.loss_and_grads
        calls = [0]

        def loss_and_grads(state, batch):
            m, g = real_lg(state, batch)
            calls[0] += 1
            if poison is not None and (rank, calls[0]) == tuple(poison):
                m["photo_loss"] = torch.full_like(m["photo_loss"],
                                                  float("nan"))
            return m, g
        step.loss_and_grads = loss_and_grads

        def run(state, batch):
            worlds.append(parallel.world_size())
            if record:
                batches.append({k2: v.numpy().copy()
                                for k2, v in batch.items()})
            state, m = step(state, batch)
            metrics.append({k2: float(v) for k2, v in m.items()})
            metrics[-1]["step"] = state.step
            if kill is not None and (rank, state.step) == tuple(kill):
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return run

    from switch_nerf_torch.models import moe as tmoe
    real_noise = tmoe.MoELayer.noise
    trunner.make_train_step = make
    if quiet_noise:
        tmoe.MoELayer.noise = lambda self, logits, g: torch.zeros_like(logits)
    try:
        with count_drops() as tally:
            state = ttrain.main(h, device="cpu")
    except ValueError as e:
        if refused:
            return {"raised": str(e), "steps": len(metrics)}
        raise
    finally:
        trunner.make_train_step = real_make
        tmoe.MoELayer.noise = real_noise
    if refused:
        raise AssertionError("the run was not refused")
    out = {"metrics": metrics, "batches": batches,
           "params": params_of(state), "step": state.step, "worlds": worlds,
           "drops": tally if drops else None,
           "generator": state.generator.get_state().numpy().copy()}
    if layout:
        from switch_nerf_torch import bridge
        out["local"] = bridge.local_state(state)
        out["optimizer"] = type(state.optimizer).__name__
        out["gathers"] = {k: v - before[k] for k, v in weights.STATS.items()
                          if isinstance(v, int)}
    return out


def evaluate(rank, h, entry, **_):
    import importlib
    mod = importlib.import_module(f"switch_nerf_torch.{entry}")
    return {"means": mod.main(h, device="cpu")}


def meters(rank, **_):
    """Unequal key sets: rank 0 scores two images, rank 1 one with an
    extra key, a third rank (if any) none."""
    from switch_nerf_torch.utils.meters import (DictAverageMeter,
                                                allgather_json)
    meter = DictAverageMeter()
    if rank == 0:
        meter.update({"psnr": 10.0, "ssim": 0.5})
        meter.update({"psnr": 12.0, "ssim": 0.7})
    elif rank == 1:
        meter.update({"ssim": 0.9, "lpips-vgg": 0.25})
    return {"gathered": allgather_json({"rank": rank, f"k{rank}": [rank]}),
            "means": meter.mean_across_processes()}


def refusals(rank, **_):
    """resolve_device in a group of more than one process: an explicit
    device wins; none means cuda:LOCAL_RANK, which must exist."""
    import switch_nerf_torch as snt
    out = {"explicit": str(snt.resolve_device("cpu"))}
    try:
        snt.resolve_device()
        out["no_cuda"] = "no error"
    except RuntimeError as e:
        out["no_cuda"] = str(e)
    avail, count = torch.cuda.is_available, torch.cuda.device_count
    torch.cuda.is_available, torch.cuda.device_count = (lambda: True,
                                                        lambda: 1)
    os.environ["LOCAL_RANK"] = "1"
    try:
        snt.resolve_device()
        out["too_few_cards"] = "no error"
    except RuntimeError as e:
        out["too_few_cards"] = str(e)
    finally:
        torch.cuda.is_available, torch.cuda.device_count = avail, count
        os.environ["LOCAL_RANK"] = str(rank)
    return out


def train_cli(rank, h, port, **kw):
    """train.main with no group of the caller's: the entry point starts
    the group from torchrun's variables and ends it on the way out."""
    parallel.destroy()
    os.environ["MASTER_PORT"] = str(port)
    out = train(rank, h, **kw)
    out["group_after"] = torch.distributed.is_initialized()
    return out


def _ep_mesh(rank, mesh_shape, experts=4, **flags):
    from argparse import Namespace

    from switch_nerf_torch.parallel import mesh as mesh_mod
    return mesh_mod.setup(Namespace(no_expert_parallel=False,
                                    mesh_shape=list(mesh_shape),
                                    moe_expert_num=experts, **flags),
                          parallel.world_size(), rank)


def exchange(rank, mesh_shape, **_):
    """The token exchange's autograd in float64 against a dense reference:
    every rank of the mesh holds [E, C_r, M] (C_r = 2 + rank, so the
    members' capacities differ) and the experts are linear maps W[e]; the
    owners apply their block through parallel/experts.chain. Returns the
    largest errors of y, dx and the local dW."""
    from switch_nerf_torch.parallel import experts as ep
    mesh = _ep_mesh(rank, mesh_shape)
    e, m = 4, 3
    w = torch.randn(e, m, m, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(100))

    def draw(r, seed):
        g = torch.Generator().manual_seed(seed * 1000 + r)
        return torch.randn(e, 2 + r, m, dtype=torch.float64, generator=g)
    lo, hi = mesh.block(e)
    w_local = w[lo:hi].clone().requires_grad_()
    x = draw(rank, 1).requires_grad_()
    ep.begin_pass()
    y = ep.chain(x, lambda z: torch.bmm(z, w_local), mesh)
    ep.end_pass(mesh)
    g = draw(rank, 2)
    (y * g).sum().backward()
    dw = sum(torch.bmm(draw(r, 1)[lo:hi].transpose(1, 2), draw(r, 2)[lo:hi])
             for r in mesh.expert_ranks())
    return {"y": float((y - torch.bmm(x, w)).abs().max()),
            "dx": float((x.grad - torch.bmm(g, w.transpose(1, 2)))
                        .abs().max()),
            "dw": float((w_local.grad - dw).abs().max()),
            "shape": list(y.shape), "group": mesh.expert_ranks(),
            "data": mesh.data_ranks(), "form": ep.STATS["form"]}


def gather(rank, mesh_shape, **_):
    """The weight gather's autograd in float64 (parallel/weights.
    GatherWeights) under --expert_weight_parallel with expert parallelism
    on `mesh_shape`: each rank gives the column blocks of its experts of
    seeded whole tensors W and weights the gathered tensors by its own
    G_r; the gathered must be its experts of W, and the blocks' gradient
    the column block of the sum of the data group's G_r. Returns the
    largest errors, the shapes and the form."""
    from switch_nerf_torch.parallel import weights as wp
    from switch_nerf_torch.parallel.mesh import DATA, EXPERT
    mesh = _ep_mesh(rank, mesh_shape, expert_weight_parallel=True)
    shapes = [(4, 6, 8), (4, 1, 8), (4, 5, 4)]
    block, cols = (EXPERT, None, None), (None, None, DATA)

    def draw(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return mesh.cut(torch.randn(*shape, dtype=torch.float64,
                                    generator=g), block)
    whole = [draw(i, s) for i, s in enumerate(shapes)]
    shards = [mesh.cut(w, cols).clone().requires_grad_() for w in whole]
    got = wp.GatherWeights.apply(mesh, *shards)
    sum(torch.sum(y * draw(100 * rank + i + 10, s))
        for i, (y, s) in enumerate(zip(got, shapes))).backward()
    want = [sum(draw(100 * r + i + 10, s) for r in mesh.data_ranks())
            for i, s in enumerate(shapes)]
    return {"y": max(float((y - w).abs().max()) for y, w in zip(got, whole)),
            "dw": max(float((sh.grad - mesh.cut(w, cols)).abs().max())
                      for sh, w in zip(shards, want)),
            "shapes": [list(sh.shape) for sh in shards],
            "whole": [list(y.shape) for y in got],
            "form": wp.STATS["form"], "data": mesh.data_ranks()}


def lockstep(rank, **_):
    """Rank 0 makes one more expert exchange in its pass than the others:
    every rank must raise, none may hang."""
    from switch_nerf_torch.parallel import experts as ep
    mesh = _ep_mesh(rank, (1, parallel.world_size()))
    x = torch.zeros(4, 2, 3)
    ep.begin_pass()
    try:
        for _ in range(2 if rank == 0 else 1):
            ep.chain(x, lambda z: z, mesh)
        ep.end_pass(mesh)
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


SCENARIOS = {"train": train, "eval": evaluate, "meters": meters,
             "refusals": refusals, "train_cli": train_cli,
             "exchange": exchange, "lockstep": lockstep, "gather": gather}


def main() -> None:
    rank, world, job_path = int(sys.argv[1]), int(sys.argv[2]), Path(
        sys.argv[3])
    job = pickle.loads(job_path.read_bytes())
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(job["port"]))
    os.environ["SWITCH_NERF_ERROR_FILE"] = str(
        job_path.with_suffix(f".rank{rank}.err.json"))
    torch.set_num_threads(2)
    # a rank that fails must not leave its peer waiting for long
    parallel.init_distributed("cpu", timeout=datetime.timedelta(seconds=180))
    results = {}
    for sc in job["scenarios"]:
        try:
            results[sc["name"]] = SCENARIOS[sc["kind"]](rank, **sc)
        except BaseException:
            results[sc["name"]] = {"error": traceback.format_exc()}
            job_path.with_suffix(f".rank{rank}.pkl").write_bytes(
                pickle.dumps(results))
            raise
    job_path.with_suffix(f".rank{rank}.pkl").write_bytes(pickle.dumps(
        results))
    parallel.destroy()


if __name__ == "__main__":
    main()

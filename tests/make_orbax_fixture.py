"""Write an orbax checkpoint of a JAX train state and its msgpack twin.

    python tests/make_orbax_fixture.py [--fixture ep|ewp_zero|all]
                                       [--out DIR] [--time-published]

The JAX package writes the sharded (orbax) format whenever a run has more
than one process (``switch_nerf_tpu/checkpoints.py:64-66``). This script
builds a tiny Building-graph train state (width 64, 2 experts, the
published routing flags; seed 0) with JAX on a virtual 8-device CPU mesh,
places its parameters and Adam moments as ``Runner._setup_device`` does
under ``--expert_parallel --mesh_shape 4 2`` (experts over the 'expert'
axis), and saves it twice with ``switch_nerf_tpu.checkpoints.
save_checkpoint``: ``orbax/<step>`` (sharded=True) and ``msgpack/<step>``
(sharded=False), with ``hparams.json``, the flags the port rebuilds the
model from. It rewrites the committed fixtures, each twin gzipped to
keep it under 1 MB (``--fixture`` picks one, ``--out`` moves it):
``tests/data/orbax_ep_fixture`` (``ep``), which ``chip_smoke.py`` serves
on the card, and ``tests/data/orbax_ewp_zero_fixture`` (``ewp_zero``):
the same graph at width 32 placed under ``--expert_parallel
--expert_weight_parallel --shard_optimizer_states --mesh_shape 4 2`` (the
experts' columns over 'data' too, and the other moments' first dimension
over 'data', ZeRO-1). ``write_pair`` is what ``tests/test_torch_orbax.py``
calls.

``--time-published``: the port's orbax read of a published-width Building
state (8 x 7 x 256 experts, its moments drawn from the seed) that JAX
wrote on the same mesh, timed on the CPU that runs the script (the port
writes no orbax, so a machine without JAX cannot make one).
"""
import argparse
import gzip
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

FIXTURE = ROOT / "tests" / "data" / "orbax_ep_fixture"
FIXTURE_EWP_ZERO = ROOT / "tests" / "data" / "orbax_ewp_zero_fixture"
STEP = 3
APPEARANCE = 8


def fixture_hparams(width: int = 64, experts: int = 2,
                    ewp_zero: bool = False):
    from tests.torch_port_helpers import tiny_building_hparams
    h = tiny_building_hparams(width)
    h.moe_expert_num = h.model["expert_num"] = experts
    h.no_expert_parallel = False
    h.mesh_shape = [4, 2]
    h.expert_weight_parallel = h.shard_optimizer_states = ewp_zero
    return h


def expert_sharded(state, h, mesh_shape=(4, 2)):
    """The state placed as JAX's runner places it under expert
    parallelism: expert leaves (and their moments) over 'expert', and
    under h's --expert_weight_parallel / --shard_optimizer_states over
    'data' too (``Runner._setup_device``)."""
    from switch_nerf_tpu.parallel.mesh import (create_mesh,
                                               opt_state_shardings,
                                               param_shardings)
    mesh = create_mesh(mesh_shape)
    e = h.moe_expert_num
    wp = getattr(h, "expert_weight_parallel", False)
    zero = getattr(h, "shard_optimizer_states", False)
    state = state.replace(params=jax.device_put(
        state.params, param_shardings(state.params, mesh, e, True, wp)))
    oshard = opt_state_shardings(state.opt_state, mesh, e, True, wp, zero)
    return state.replace(opt_state=jax.tree_util.tree_map(
        lambda x, s: jax.device_put(np.asarray(x), s), state.opt_state,
        oshard))


def with_moments(state, seed: int, step: int):
    """The state at `step` with Adam moments drawn from `seed` (mu
    normal in steps of 2^-12, so that they compress, nu its square), as a
    trained state holds them."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return np.full_like(x, step)
        return (np.round(rng.standard_normal(x.shape) * 4)
                * 2.0 ** -12).astype(x.dtype)
    opt = state.opt_state
    adam = opt[0]
    mu = jax.tree_util.tree_map(draw, adam.mu)
    nu = jax.tree_util.tree_map(lambda m: np.square(m), mu)
    adam = adam._replace(count=np.asarray(step, np.int32), mu=mu, nu=nu)
    opt = (adam,) + tuple(jax.tree_util.tree_map(draw, o) for o in opt[1:])
    return state.replace(step=np.asarray(step, np.int32), opt_state=opt)


def build_state(h, seed: int = 0, step: int = STEP,
                appearance: int = APPEARANCE):
    from switch_nerf_tpu import trainer as jtrainer
    from switch_nerf_tpu.models import model_utils as jmu
    state = jtrainer.create_train_state(
        jax.random.PRNGKey(seed), h, jmu.get_nerf(h, appearance),
        jmu.get_bg_nerf(h, appearance))
    return expert_sharded(with_moments(state, seed, step), h)


def write_pair(out: Path, h, seed: int = 0, gzip_twin: bool = False,
               appearance: int = APPEARANCE) -> dict:
    """orbax/<STEP> and msgpack/<STEP> of one state under `out`, and
    hparams.json; returns the two step directories. `gzip_twin`: the
    msgpack twin as state.msgpack.gz (the committed fixture)."""
    from switch_nerf_tpu import checkpoints as jckpt
    out = Path(out)
    if out.exists():
        shutil.rmtree(out)
    state = build_state(h, seed, appearance=appearance)
    jckpt.save_checkpoint(out / "orbax", state, sharded=True)
    jckpt.save_checkpoint(out / "msgpack", state, sharded=False)
    if gzip_twin:
        twin = out / "msgpack" / str(STEP) / "state.msgpack"
        Path(f"{twin}.gz").write_bytes(gzip.compress(twin.read_bytes(),
                                                     mtime=0))
        twin.unlink()
    (out / "hparams.json").write_text(json.dumps(
        {k: v for k, v in vars(h).items()}, default=str, sort_keys=True))
    return {"orbax": out / "orbax" / str(STEP),
            "msgpack": out / "msgpack" / str(STEP)}


def time_published() -> float:
    """Seconds of the port's orbax read of a published-width Building
    state, on the CPU that runs it."""
    from switch_nerf_tpu.config import get_opts, parse_args
    from switch_nerf_torch import orbax_read
    h = parse_args(get_opts(), [
        "--config_file", str(ROOT / "configs/switch_nerf/building.yaml"),
        "--exp_name", "unused", "--dataset_path", str(ROOT), "--use_moe",
        "--use_moe_external_gate", "--use_gate_input_norm",
        "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
        "--moe_expert_num", "8", "--appearance_dim", "48",
        "--moe_train_batch", "--expert_parallel", "--mesh_shape", "4", "2"])
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_pair(Path(tmp), h)
        size = sum(p.stat().st_size for p in dirs["orbax"].rglob("*")
                   if p.is_file())
        t0 = time.perf_counter()
        orbax_read.read_tree(dirs["orbax"] / "orbax")
        seconds = time.perf_counter() - t0
    print(f"published-width Building state: {size} B of orbax files read "
          f"in {seconds:.2f} s on the CPU")
    return seconds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixture", choices=("ep", "ewp_zero", "all"),
                    default="all")
    ap.add_argument("--out", type=Path, default=None,
                    help="output directory (one fixture)")
    ap.add_argument("--time-published", action="store_true")
    args = ap.parse_args()
    if args.out and args.fixture == "all":
        ap.error("--out writes one fixture: give --fixture ep or ewp_zero")
    if args.time_published:
        time_published()
        return 0
    # the EWP + ZeRO-1 fixture at width 32, to stay under 1 MB
    todo = {"ep": (FIXTURE, fixture_hparams()),
            "ewp_zero": (FIXTURE_EWP_ZERO,
                         fixture_hparams(width=32, ewp_zero=True))}
    for name in (todo if args.fixture == "all" else [args.fixture]):
        out, h = todo[name]
        out = args.out or out
        dirs = write_pair(out, h, gzip_twin=True)
        size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
        print(f"wrote {dirs} ({size} B)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Every method's data-parallel training against its plain training, on
the CPU.

One module-scoped fixture starts, all at once, processes of
tests/torch_parallel_worker.py ("methods" mode), each with a timeout:
- a pair of gloo ranks that run ns-train (`scripts.train.main`,
  `--trainer.num-devices 2`) of every method's tiny configuration
  (`torch_parallel_worker.TINY`: the widths of each method's own CPU
  test, f32) in turn: 2 steps, 3 for instant-ngp and instant-ngp-bounded
  (a grid update at steps 0 and 2, a dynamic batch size after steps 0
  and 2), tensorf's grids upsampled after step 0, splatfacto refined
  after step 1;
- one plain process that runs the same ns-train commands without a
  process group: the same global batches and draws (the ranks keep their
  rows of them);
- one rank alone in a gloo group, for nerfacto: bitwise the plain run.

One case per method holds rank 0's global scalars of every step against
the plain run's (rel 1e-4 at step 0, 1e-3 later, as
tests/test_torch_parallel.py), the parameters' updates by that file's
flip rule, and the two ranks' parameters and extra state bitwise equal
(the ray-batch methods sum their gradients in one all-reduce; splatfacto
and generfacto take rank 0's gradients). The scenes are written here
with the JAX package's test fixtures, once.

vanilla-nerf and mipnerf (REPLAYED) resample the plain run's coarse
weights in the ranks (torch_parallel_worker.pdf_weights): the ranks'
coarse fields, run on half the rays, give weights an ulp away, and the
fine field's 10 position frequencies with Adam's second step turn the
moved fine samples into sign flips of ~25% of the fine base's first
layers. A pair of vanilla-nerf ranks whose rank 1 doubles its gradient
is the negative control: the same check fails on it.
"""

import json

import numpy as np
import pytest

from nerfstudio_thermal_torch.models.tensorf import resize_grid
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_all_methods_train import make_blender_fixture, make_ingp_fixture
from tests.test_torch_depth_nerfacto import write_depth_scene
from tests.test_torch_semantic_nerfw import sitcoms_scene
from tests.torch_parallel_worker import TINY, run_groups

LOSS_TOL = 1e-4
LATER_LOSS_TOL = 1e-3
PARAM_TOL = 1e-3
FLIP = 1e-3
MAX_FLIPPED = 0.25
REPLICATED = ("splatfacto", "generfacto")
REPLAYED = ("mipnerf", "vanilla-nerf")
FAULT = {"label": "vanilla-nerf", "rank": 1, "grad_scale": 2.0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("methods")
    scenes = {
        "rgbt": make_synthetic_rgbt_dataset(root / "rgbt", num_pairs=4),
        "splat": make_synthetic_rgbt_dataset(root / "splat", num_pairs=3, rgb_hw=(16, 20), t_hw=(16, 20)),
        "blender": make_blender_fixture(root / "blender", n=3, hw=(12, 16)),
        "ingp": make_ingp_fixture(root / "ingp", n=5),
        "depth": write_depth_scene(root / "depth"),
        "sitcoms": sitcoms_scene(root / "sitcoms"),
    }
    spec = {"methods": sorted(TINY), "scenes": {k: str(v) for k, v in scenes.items()}}
    replay = {label: str(root / "plain") for label in REPLAYED}
    run_groups([({**spec, "replay_pdf": replay}, root / "ranks", 2),
                ({**spec, "group": False, "record_pdf": list(REPLAYED)}, root / "plain", 1),
                ({**spec, "methods": ["nerfacto"]}, root / "one", 1),
                ({**spec, "methods": [FAULT["label"]], "replay_pdf": replay, "fault": FAULT}, root / "fault", 2)])
    return root


def scalars(root, label, rank=0):
    return json.loads((root / f"{label}_rank{rank}.json").read_text())


def arrays(root, label, rank=0):
    return dict(np.load(root / f"{label}_rank{rank}.npz"))


def assert_updates_close(label, got, want):
    """Each state-dict entry's update from its start: fewer than
    MAX_FLIPPED of its entries moved the other way (by more than FLIP of
    the largest update), the others within PARAM_TOL relative L2; an
    entry the plain run did not move stays where it was."""
    for key in sorted(k for k in want if k.startswith("after/model/")):
        before = want[key.replace("after/", "before/", 1)].astype(np.float64)
        g, w = got[key].astype(np.float64), want[key].astype(np.float64)
        if before.shape != w.shape:  # tensorf's grids, upsampled after step 0 (linear in the grid)
            before = resize_grid(before, w.shape[1]).astype(np.float64)
        want_d, got_d = w - before, g - before
        if not np.abs(want_d).max() > 0:
            np.testing.assert_array_equal(got_d, want_d, err_msg=f"{label} {key}")
            continue
        flipped = np.abs(got_d - want_d) > FLIP * np.abs(want_d).max()
        assert flipped.mean() < MAX_FLIPPED, (label, key, flipped.mean())
        err = np.linalg.norm(got_d[~flipped] - want_d[~flipped]) / np.linalg.norm(want_d[~flipped])
        assert err <= PARAM_TOL, (label, key, err)


def check_two_ranks(ranks, plain_dir, label):
    """Rank 0's scalars and updates of `label` in the run under `ranks`
    against the plain run's, and both ranks' state equal."""
    got, want = scalars(ranks, label), scalars(plain_dir, label)
    assert len(got) == len(want) == TINY[label][4]
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (label, step, set(g) ^ set(w))
        tol = LOSS_TOL if step == 0 else LATER_LOSS_TOL
        for k, v in w.items():
            assert np.isfinite(g[k]), (label, step, k)
            assert abs(g[k] - v) <= tol * max(abs(v), 1e-3), (label, step, k, g[k], v)
    # every rank logs the same global scalars and ends with the same state
    assert scalars(ranks, label, 1) == got
    r0, r1, plain = arrays(ranks, label), arrays(ranks, label, 1), arrays(plain_dir, label)
    assert set(r0) == set(r1) == set(plain)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"{label} {k}")
        if k.startswith("before/"):
            np.testing.assert_array_equal(r0[k], plain[k], err_msg=f"{label} {k}")
    if label in REPLICATED:
        # rank 0 runs the plain step on the replicated batch
        for k in r0:
            np.testing.assert_array_equal(r0[k], plain[k], err_msg=f"{label} {k}")
    else:
        assert_updates_close(label, r0, plain)


@pytest.mark.parametrize("label", sorted(TINY))
def test_two_ranks_match_the_plain_run(runs, label):
    check_two_ranks(runs / "ranks", runs / "plain", label)


def test_a_doubled_rank_fails_the_check(runs):
    """The negative control: vanilla-nerf's ranks with the plain run's
    fine samples, rank 1's gradients doubled before the all-reduce."""
    with pytest.raises(AssertionError):
        check_two_ranks(runs / "fault", runs / "plain", FAULT["label"])


def test_extra_state_of_the_ranks(runs):
    """instant-ngp's occupancy grids (updated at steps 0 and 2) and
    splatfacto's alive mask after its refinement are equal on both ranks
    (test_two_ranks_match_the_plain_run holds them bitwise); here they
    are shown to have changed."""
    for label in ("instant-ngp", "instant-ngp-bounded"):
        r0 = arrays(runs / "ranks", label)
        grids = [k for k in r0 if k.startswith("after/extra/") and r0[k].dtype.kind == "f" and r0[k].size > 1]
        assert grids and any(not np.array_equal(r0[k], r0[k.replace("after/", "before/", 1)]) for k in grids)
    r0 = arrays(runs / "ranks", "splatfacto")
    assert not np.array_equal(r0["after/extra/alive"], r0["before/extra/alive"])


def test_one_rank_group_is_the_plain_run(runs):
    """nerfacto in a one-rank gloo group (shard, contributions,
    all-reduces) gives bitwise the plain run's scalars and state."""
    assert scalars(runs / "one", "nerfacto") == scalars(runs / "plain", "nerfacto")
    one, plain = arrays(runs / "one", "nerfacto"), arrays(runs / "plain", "nerfacto")
    assert set(one) == set(plain)
    for k in one:
        np.testing.assert_array_equal(one[k], plain[k], err_msg=k)

"""The port's optimizer surface against optax, on the CPU: RAdam, AdamW,
global-norm clipping, the multi-step and cosine schedules, and gradient
accumulation (optax.MultiSteps), each as the JAX package builds it.

- Per group over 8 steps of seeded random gradients (some steps without a
  gradient for one tensor, counted as zeros as optax sees them): the
  parameters and both moments after every step within rel L2 1e-5 per
  tensor, a few f32 ulps (the same f32 Adam arithmetic in another order,
  one ulp apart in places; the learning rates agree to one ulp, the
  clipping norm is the same f32 sum of squares). RAdam's rectification
  switches on at its 6th update (rho >= 5), inside the 8 steps.
- Gradient accumulation k = 2 over 4 steps, optimizer level: the same,
  and the parameters move only on the 2nd and 4th step. Trainer level: 4
  steps of the tiny thermal-nerfacto-tpu (tests/test_torch_train.py's
  harness) with `gradient_accumulation_steps` 2 against the JAX step with
  optax.MultiSteps: every step's losses (rel 1e-4), the parameters
  unchanged after steps 1 and 3 and equal to JAX's after 2 and 4 (rel L2
  1e-3, tests/test_torch_train.py's), the counts, and a checkpoint taken
  between two mini-steps resumes to the same next step, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerfstudio_thermal_tpu.engine import optimizers as jax_optimizers
from nerfstudio_thermal_tpu.engine import schedulers as jax_schedulers
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.engine import optimizers, schedulers
from nerfstudio_thermal_torch.engine.optimizers import MultiSteps
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_train import LOSS_TOL, JaxSide, _method, flat, rel_l2

torch.set_num_threads(1)

STEPS = 8
TOL = 1e-5
SHAPES = {"a": (5, 3), "b": (7,)}


def _group(pkg, opt_cls, sched, **opt_kwargs):
    o = getattr(pkg[0], opt_cls)(**opt_kwargs)
    s = None if sched is None else getattr(pkg[1], sched[0])(**sched[1])
    return pkg[0].OptimizerGroupConfig(optimizer=o, scheduler=s)


CASES = {
    "radam": ("RAdamOptimizerConfig", None, dict(lr=1e-2, eps=1e-8)),
    "radam-clip-cosine": ("RAdamOptimizerConfig", ("CosineDecaySchedulerConfig", dict(warm_up_end=2, max_steps=7)),
                          dict(lr=1e-2, eps=1e-15, max_norm=0.8)),
    "adamw": ("AdamOptimizerConfig", None, dict(lr=5e-3, eps=1e-15, weight_decay=0.1)),
    "adamw-multistep": ("AdamOptimizerConfig", ("MultiStepSchedulerConfig", dict(milestones=(2, 5), gamma=0.5)),
                        dict(lr=1e-2, eps=1e-8, weight_decay=1e-2)),
    "adam-clip-exponential": ("AdamOptimizerConfig", ("ExponentialDecaySchedulerConfig", dict(lr_final=1e-4, max_steps=6)),
                              dict(lr=1e-2, eps=1e-15, max_norm=1.0)),
    "radam-type-flag": ("AdamOptimizerConfig", ("CosineDecaySchedulerConfig", dict(warm_up_end=0, max_steps=5)),
                        dict(lr=1e-2, eps=1e-15, optimizer_type="radam", max_norm=2.0)),
}
JAX = (jax_optimizers, jax_schedulers)
PORT = (optimizers, schedulers)


def _draws(seed, steps):
    """Per step {group: {tensor: gradient or None}}; tensor b has none on
    steps 2 and 5. Gradient sizes vary so that clipping acts on some steps
    and not on others."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        scale = (0.1, 3.0)[step % 2]
        out.append({g: {k: (None if (k == "b" and step in (2, 5)) else
                            (scale * rng.standard_normal(shape)).astype(np.float32))
                        for k, shape in SHAPES.items()} for g in ("g0", "g1")})
    return out


def _run_both(configs, draws, every_k=1):
    """Each package's optimizer over `draws`; yields (step, jax params,
    jax state, port optimizer, port params) after each step."""
    rng = np.random.default_rng(0)
    init = {g: {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for g in configs}
    jparams = jax.tree.map(jnp.asarray, init)
    tx = jax_optimizers.build_optimizer({g: c[0] for g, c in configs.items()}, jparams)
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(params, state, grads):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    tparams = {g: {k: torch.nn.Parameter(torch.tensor(v)) for k, v in d.items()} for g, d in init.items()}
    opt = optimizers.build_optimizer({g: c[1] for g, c in configs.items()},
                                     {g: list(d.values()) for g, d in tparams.items()})
    if every_k > 1:
        opt = MultiSteps(opt, every_k)
    for step, draw in enumerate(draws):
        grads = {g: {k: jnp.zeros(SHAPES[k]) if v is None else jnp.asarray(v) for k, v in d.items()}
                 for g, d in draw.items()}
        jparams, jstate = jstep(jparams, jstate, grads)
        opt.zero_grad()
        for g, d in draw.items():
            for k, v in d.items():
                tparams[g][k].grad = None if v is None else torch.tensor(v)
        applied = opt.step()
        yield step, jparams, jstate, opt, tparams, applied


def _moments(state, group):
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)  # noqa: E731
    adam = [s for s in jax.tree_util.tree_leaves(state.inner_states[group], is_leaf=is_adam) if is_adam(s)][0]
    return int(adam.count), adam.mu[group], adam.nu[group]


def _close(got, want, what):
    assert rel_l2(got, want) <= TOL, (what, rel_l2(got, want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_optimizer_matches_optax(case):
    """Two groups of the same configuration (the clipping norm is each
    group's own) over 8 steps: parameters and moments after each."""
    opt_cls, sched, kwargs = CASES[case]
    configs = {g: (_group(JAX, opt_cls, sched, **kwargs), _group(PORT, opt_cls, sched, **kwargs)) for g in ("g0", "g1")}
    for step, jparams, jstate, opt, tparams, _ in _run_both(configs, _draws(1, STEPS)):
        for g in configs:
            count, mu, nu = _moments(jstate, g)
            assert count == opt.groups[g].count == step + 1
            for i, k in enumerate(SHAPES):
                _close(tparams[g][k].detach().numpy(), jparams[g][k], (case, step, g, k, "param"))
                _close(opt.groups[g].mu[i].numpy(), mu[k], (case, step, g, k, "mu"))
                _close(opt.groups[g].nu[i].numpy(), nu[k], (case, step, g, k, "nu"))


def test_radam_rectification_starts_at_the_sixth_update():
    """rho_t = rho_inf - 2 t b2^t / (1 - b2^t) first reaches 5 at t = 6
    (b2 0.999): RAdam's first five updates are the bias-corrected momentum,
    the later ones rectified."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = optimizers.Adam([p], lambda step: 1.0, eps=1e-8, kind="radam")
    factors = []
    for _ in range(8):
        opt.count += 1
        factors.append(opt._radam_factor())
    assert factors[:5] == [None] * 5 and all(0 < f < 1 for f in factors[5:])


@pytest.mark.parametrize("case", ["radam-clip-cosine", "adamw-multistep"])
def test_gradient_accumulation_matches_multisteps(case):
    """k = 2 over 4 steps (8 mini-steps here: 4 updates) against
    optax.MultiSteps: the mean of each pair, the counts and schedules
    advancing per update, the parameters still between updates."""
    opt_cls, sched, kwargs = CASES[case]
    configs = {g: (_group(JAX, opt_cls, sched, **kwargs), _group(PORT, opt_cls, sched, **kwargs)) for g in ("g0", "g1")}
    before = None
    for step, jparams, jstate, opt, tparams, applied in _run_both(configs, _draws(2, STEPS), every_k=2):
        assert applied == (step % 2 == 1) and opt.mini_step == int(jstate.mini_step)
        now = {g: {k: v.detach().clone() for k, v in d.items()} for g, d in tparams.items()}
        if not applied and before is not None:
            assert all(torch.equal(now[g][k], before[g][k]) for g in now for k in now[g])
        before = now
        for g in configs:
            count, mu, _ = _moments(jstate.inner_opt_state, g)
            assert count == opt.groups[g].count == (step + 1) // 2
            for i, k in enumerate(SHAPES):
                _close(tparams[g][k].detach().numpy(), jparams[g][k], (case, step, g, k, "param"))
                _close(opt.groups[g].mu[i].numpy(), mu[k], (case, step, g, k, "mu"))
                _close(opt.acc[g][i].numpy(), jstate.acc_grads[g][k], (case, step, g, k, "acc"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


def test_trainer_accumulation_matches_jax_multisteps(scene, tmp_path):
    """The trainer with gradient_accumulation_steps 2 against the JAX step
    with optax.MultiSteps, 4 steps from step 100 (the proposal nets update
    on steps 100 and 102 only): losses of every step, parameters still on
    steps 1 and 3 and equal to JAX's after 2 and 4, counts, and a checkpoint
    taken after step 1 that resumes to the same step 2."""
    js = JaxSide(scene, "float32")
    tx = optax.MultiSteps(js.tx, every_k_schedule=2)
    core = jax_make_ray_train_step(js.model, tx)
    step_fn = jax.jit(lambda st, b: core(st, b, js.cameras))
    state = JaxTrainState(
        params=js.params, opt_state=tx.init(js.params), step=jnp.asarray(100, jnp.int32),
        steps_since_update=jnp.asarray(2, jnp.int32), steps_since_update_thermal=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(42), extra=None,
    )
    method = _method(get_method_config, "float32", scene)
    method.trainer.gradient_accumulation_steps = 2
    trainer = setup_trainer(method, base_dir=tmp_path / "a", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, js.params))
    trainer.setup()
    assert isinstance(trainer.optimizers, MultiSteps)
    trainer.state.step, trainer.state.steps_since_update = 100, 2
    previous = flat(export_jax_tree(trainer.model))
    other = None
    for i in range(4):
        batch = js.batch(100 + i)
        uniforms = js.uniforms(state.rng)
        state, want = step_fn(state, batch)
        tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
        got = trainer._train_step(trainer.state, tbatch, uniforms=uniforms)
        for k, w in want.items():
            assert abs(float(got[k]) - float(w)) <= LOSS_TOL["float32"] * max(abs(float(w)), 1e-3), (i, k)
        params = flat(export_jax_tree(trainer.model))
        if i % 2 == 0:
            assert all(np.array_equal(params[k], previous[k]) for k in params), i
        else:
            want_p = flat(jax.tree.map(np.asarray, state.params))
            keys = sorted(want_p)
            got_c = np.concatenate([params[k].ravel() for k in keys])
            want_c = np.concatenate([want_p[k].ravel() for k in keys])
            assert rel_l2(got_c, want_c) <= 1e-3, (i, rel_l2(got_c, want_c))
        previous = params
        assert trainer.state.step == int(state.step) == 101 + i
        assert trainer.state.steps_since_update == int(state.steps_since_update)
        assert all(opt.count == (i + 1) // 2 for opt in trainer.optimizers.groups.values())
        if other is not None:
            # the run resumed from the checkpoint of step 101 takes step 102 alike
            again = other._train_step(other.state, tbatch, uniforms=uniforms)
            assert all(float(again[k]) == float(got[k]) for k in got)
            resumed = flat(export_jax_tree(other.model))
            assert all(np.array_equal(resumed[k], params[k]) for k in params)
            other = None
        if i == 0:
            path = trainer.save_checkpoint(101)
            method.trainer.load_dir = path.parent
            other = setup_trainer(method, base_dir=tmp_path / "b", device="cpu")
            other.setup()
            assert other.optimizers.mini_step == 1 and other._start_step == 101

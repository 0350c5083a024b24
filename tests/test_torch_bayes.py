"""The port's Bayesian optimization against the JAX package's: TPE and GP
in lockstep on the same seed and observations, the port's GP regressor
against scikit-learn's (which the JAX GP fits), async Thompson sampling's
joint draw, and get_XY's busy-location imputation and interim rows."""

import warnings

import numpy as np
import pytest
from sklearn.gaussian_process import GaussianProcessRegressor as SkGPR
from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

from maggy_tpu.optimizers.bayes import GP as JaxGP
from maggy_tpu.optimizers.bayes import TPE as JaxTPE
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.trial import Trial as JaxTrial
from maggy_tpu_torch.optimizers.bayes import GP, TPE, gpr
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

MIXED = dict(x=("DOUBLE", [0.0, 1.0]), lr=("DOUBLE_LOG", [1e-5, 1e-1]),
             n=("INTEGER", [1, 8]), b=("DISCRETE", [16, 32, 64]),
             act=("CATEGORICAL", ["relu", "gelu", "tanh"]))


def objective(p):
    """Deterministic, with its optimum inside the mixed space."""
    return ((p["x"] - 0.3) ** 2 + (np.log10(p["lr"]) + 3) ** 2 / 10 + abs(p["n"] - 5) / 10
            + {16: 0.1, 32: 0.0, 64: 0.2}[p["b"]]
            + {"relu": 0.0, "gelu": 0.05, "tanh": 0.3}[p["act"]])


def wire(opt, space, num_trials, direction="min"):
    opt.searchspace = space
    opt.num_trials = num_trials
    opt.trial_store = {}
    opt.final_store = []
    opt.direction = direction
    opt._initialize()
    return opt


def lockstep(opt, num_trials, workers=2):
    """Suggest/report cycles as the driver runs them: up to ``workers``
    trials in flight (busy locations), the oldest finalizing first.
    Returns (params, sample_type) in suggestion order."""
    out, in_flight = [], []
    while True:
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
            out.append((dict(t.params), t.info_dict["sample_type"]))
        if not in_flight:
            return out
        t = in_flight.pop(0)
        t.final_metric = objective(t.params)
        opt.trial_store.pop(t.trial_id)
        opt.final_store.append(t)
        opt.report(t)


def run_jax(opt, num_trials):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's ConvergenceWarning on tiny fits
        return lockstep(wire(opt, JaxSearchspace(**MIXED), num_trials), num_trials)


def test_tpe_suggestions_identical_to_jax():
    ours = lockstep(wire(TPE(seed=0, num_warmup_trials=5), Searchspace(**MIXED), 20), 20)
    ref = run_jax(JaxTPE(seed=0, num_warmup_trials=5), 20)
    assert len(ours) == 20
    assert sum(s == "model" for _, s in ours) >= 3
    assert ours == ref


@pytest.mark.parametrize("kwargs", [
    dict(acquisition="ei"), dict(acquisition="pi"), dict(acquisition="lcb"),
    dict(async_strategy="asy_ts")], ids=["ei", "pi", "lcb", "asy_ts"])
def test_gp_proposals_match_jax(kwargs):
    """Proposals within 1e-4 in the unit-cube transform (the AsyTS case
    also holds the joint Thompson draw: a different draw proposes another
    candidate of the 100)."""
    ours = lockstep(wire(GP(seed=3, num_warmup_trials=5, **kwargs), Searchspace(**MIXED), 14), 14)
    ref = run_jax(JaxGP(seed=3, num_warmup_trials=5, **kwargs), 14)
    sp = Searchspace(**MIXED)
    assert [s for _, s in ours] == [s for _, s in ref]
    assert sum(s == "model" for _, s in ours) >= 3
    np.testing.assert_allclose(sp.transform_batch([p for p, _ in ours]),
                               sp.transform_batch([p for p, _ in ref]), rtol=0, atol=1e-4)


def sk_kernel(d):
    """The JAX GP's kernel (``maggy_tpu/optimizers/bayes/gp.py:59-71``)."""
    return ConstantKernel(1.0, (0.01, 100.0)) * Matern(
        length_scale=np.full(d, 0.3), length_scale_bounds=(0.01, 10.0), nu=2.5) \
        + WhiteKernel(1e-4, (1e-8, 1e-1))


def gp_data(seed, n, d):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.normal(size=n)
    return X, y, rng.uniform(size=(40, d))


@pytest.mark.parametrize("seed,n,d", [(0, 6, 2), (1, 12, 3), (2, 20, 4)])
def test_regressor_matches_sklearn_at_fixed_hyperparameters(seed, n, d):
    X, y, Xt = gp_data(seed, n, d)
    ours = gpr.GaussianProcessRegressor(np.full(d, 0.3), optimize=False)
    theta = np.random.default_rng(seed).uniform(ours.bounds[:, 0], ours.bounds[:, 1])
    ours.theta = theta
    ours.fit(X, y)
    ref = SkGPR(kernel=sk_kernel(d).clone_with_theta(theta), normalize_y=True,
                optimizer=None).fit(X, y)
    lml, grad = gpr.log_marginal_likelihood(theta, X, ours.y_train, eval_gradient=True)
    ref_lml, ref_grad = ref.log_marginal_likelihood(theta, eval_gradient=True)
    np.testing.assert_allclose(lml, ref_lml, rtol=1e-8)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-8, atol=1e-12)
    mean, std = ours.predict(Xt, return_std=True)
    ref_mean, ref_std = ref.predict(Xt, return_std=True)
    np.testing.assert_allclose(mean, ref_mean, rtol=1e-8)
    np.testing.assert_allclose(std, ref_std, rtol=1e-8)
    # The gradient against central differences of the likelihood itself.
    eps = 1e-6
    fd = [(gpr.log_marginal_likelihood(theta + eps * e, X, ours.y_train)
           - gpr.log_marginal_likelihood(theta - eps * e, X, ours.y_train)) / (2 * eps)
          for e in np.eye(len(theta))]
    np.testing.assert_allclose(grad, fd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed,n,d", [(3, 8, 2), (4, 15, 3), (5, 25, 5)])
def test_ml2_fit_matches_sklearn(seed, n, d):
    """ML-II from the initial theta plus one log-uniform restart drawn from
    RandomState(random_state): the fitted log-hyperparameters within 1e-3
    of sklearn's, and the posterior they give."""
    X, y, Xt = gp_data(seed, n, d)
    ours = gpr.GaussianProcessRegressor(np.full(d, 0.3), n_restarts_optimizer=1,
                                        random_state=seed + 100).fit(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = SkGPR(kernel=sk_kernel(d), normalize_y=True, n_restarts_optimizer=1,
                    random_state=seed + 100).fit(X, y)
    np.testing.assert_allclose(ours.theta, ref.kernel_.theta, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours.predict(Xt), ref.predict(Xt), rtol=1e-6, atol=1e-9)


def test_constant_targets_and_joint_draw_match_sklearn():
    """A target std of 0 counts as 1, and sample_y draws jointly with
    RandomState(seed).multivariate_normal over the predictive covariance."""
    X, _, Xt = gp_data(6, 10, 3)
    y = np.full(10, 0.25)
    theta = np.log([1.0, 0.3, 0.4, 0.5, 1e-4])
    ours = gpr.GaussianProcessRegressor(np.full(3, 0.3), optimize=False)
    ours.theta = theta
    ours.fit(X, y)
    ref = SkGPR(kernel=sk_kernel(3).clone_with_theta(theta), normalize_y=True,
                optimizer=None).fit(X, y)
    assert ours.y_std == 1.0
    np.testing.assert_allclose(ours.predict(Xt), ref.predict(Xt), rtol=1e-12)
    X, y, Xt = gp_data(7, 10, 3)
    ours.fit(X, y)
    ref.fit(X, y)
    _, cov = ours.predict(Xt, return_cov=True)
    np.testing.assert_allclose(cov, ref.predict(Xt, return_cov=True)[1], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(ours.sample_y(Xt, random_state=11),
                               ref.sample_y(Xt, random_state=11), rtol=0, atol=1e-6)


def paired_state(interim=False):
    """A port GP and a JAX GP over the same finalized trials (with heartbeat
    histories) and the same two in-flight trials."""
    kw = dict(seed=4, num_warmup_trials=0, interim_results=interim,
              interim_results_interval=3)
    ours = wire(GP(**kw), Searchspace(**MIXED), 20, direction="max")
    ref = wire(JaxGP(**kw), JaxSearchspace(**MIXED), 20, direction="max")
    params = Searchspace(**MIXED).get_random_parameter_values(10, rng=np.random.default_rng(9))
    for i, p in enumerate(params):
        for opt, cls in ((ours, Trial), (ref, JaxTrial)):
            t = cls(dict(p))
            if i < 8:
                for step in range(7 + i % 3):
                    t.append_metric(-objective(p) * (1 + 1.0 / (step + 1)), step)
                t.final_metric = -objective(p)
                opt.final_store.append(t)
            else:
                opt.trial_store[t.trial_id] = t
    return ours, ref


@pytest.mark.parametrize("strategy", ["cl_min", "cl_max", "cl_mean", "kb", "interim"])
def test_get_xy_matches_jax(strategy):
    ours, ref = paired_state(interim=strategy == "interim")
    if strategy == "interim":
        kw = dict(interim=True)
    else:
        kw = dict(include_busy_locations=True, impute_strategy=strategy)
        if strategy == "kb":
            # Kriging believer: the posterior mean of the current model.
            for opt in (ours, ref):
                store, opt.trial_store = opt.trial_store, {}
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    opt.update_model(0)
                opt.trial_store = store
    X, y = ours.get_XY(**kw)
    X_ref, y_ref = ref.get_XY(**kw)
    assert X.shape == X_ref.shape and X.shape[0] == len(y)
    np.testing.assert_allclose(X, X_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(y, y_ref, rtol=1e-8, atol=1e-12)
    if strategy != "interim":
        assert X.shape[0] == 10
        assert ours.imputed_metrics == pytest.approx(ref.imputed_metrics, rel=1e-8)
    else:
        assert X.shape[1] == len(MIXED) + 1 and X.shape[0] > 8


def test_observation_helpers_match_jax():
    """What a custom optimizer reads: the direction-normalized metric and
    hparam arrays (all and per budget), ybest/yworst/ymean, duplicates,
    and the pruner's max budget."""
    ours, ref = paired_state()
    for opt in (ours, ref):
        for i, t in enumerate(opt.final_store):
            t.params["budget"] = 3 if i % 2 else 1
    for budget in (None, 1, 3):
        np.testing.assert_allclose(ours.get_metrics_array(budget), ref.get_metrics_array(budget))
        np.testing.assert_allclose(ours.get_hparams_array(budget), ref.get_hparams_array(budget))
        for name in ("ybest", "yworst", "ymean"):
            assert getattr(ours, name)(budget) == getattr(ref, name)(budget)
    in_flight = next(iter(ours.trial_store.values()))
    assert ours.hparams_exist(Trial(dict(in_flight.params, budget=9)))
    assert not ours.hparams_exist(Trial({**in_flight.params, "x": -1.0}))
    with pytest.raises(ValueError, match="pruner"):
        ours.get_max_budget()
    hb = GP(seed=0, pruner="hyperband", pruner_kwargs=dict(min_budget=1, max_budget=27, eta=3))
    assert hb.init_pruner().max_budget == hb.get_max_budget() == 27


def test_fork_eps_raises_and_invalid_args():
    # fork_eps is ported (near-duplicate warm starts; tests/test_torch_fork.py
    # holds it against the JAX package): accepted, and off by default.
    assert GP(fork_eps=0.1).fork_eps == TPE(fork_eps=0.1).fork_eps == 0.1
    assert GP().fork_eps is None and TPE().fork_eps is None
    with pytest.raises(ValueError, match="interim"):
        TPE(interim_results=True)
    with pytest.raises(ValueError, match="async_strategy"):
        GP(async_strategy="bogus")
    with pytest.raises(ValueError, match="acquisition"):
        GP(acquisition="bogus")
    assert GP.SUGGEST_COST == TPE.SUGGEST_COST == "expensive"

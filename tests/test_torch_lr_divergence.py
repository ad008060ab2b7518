"""The paper autoencoder at the paper's lr 1e-3 against ``repro``'s,
through the experiment pipeline (``core/experiment.py``): it diverges in
some seeds on the unnormalised Comms-ML features, with no failure, in
``repro`` as in the port, and at lr 1e-4 in none.  The data and helpers
are ``test_torch_experiment.py``'s; a file of its own, since the paper
autoencoder's plain fused round (P = 49,680) takes most of its ~25 s.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro_torch.api as T
from repro.core import experiment as JX
from repro.data import commsml
from repro_torch.models.params import from_numpy_tree
from test_torch_experiment import (ATOL, AUROC_ATOL, RTOL, _base, _both,
                                   _data_spec, data)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROUNDS = 8


def _paper_ae_spec(api, data, lr):
    """The paper autoencoder (``repro``'s default widths, P = 49,680)
    under tolfl k = 5 without failure, 8 seeds, 8 rounds, dropout off."""
    return api.ExperimentSpec(
        data=_data_spec(api, data,
                        api.AutoencoderConfig(input_dim=commsml.N_FEATURES)),
        base=dataclasses.replace(_base(api), rounds=ROUNDS, lr=lr),
        cells=(api.CellSpec("tolfl", 5),),
        traces=api.TraceSpec(traces=(api.NO_FAILURE,)),
        seeds=api.SeedSpec(tuple(range(8))))


@pytest.mark.parametrize("lr", [1e-3, 1e-4])
def test_paper_autoencoder_diverges_at_lr_1e3_like_repro(data, lr):
    """At the paper's lr 1e-3 the paper autoencoder diverges in some seeds
    on the unnormalised Comms-ML features, with no failure at all, in
    ``repro`` as in the port: through plan -> execute with ``repro``'s
    inits, the same seeds turn non-finite in the same rounds and stay so;
    the curves agree within the experiment tests' tolerances up to each
    seed's first overshoot (a round whose loss exceeds the first round's:
    past it the unstable step amplifies float32 rounding), and the AUROCs
    within 1e-3.
    At lr 1e-4 no seed diverges.  ``chip_smoke.py`` lets the
    autoencoder's single-model cells diverge at lr 1e-3 in a minority of
    their scenarios on the strength of this test."""
    jspec, tspec = _both(lambda api: _paper_ae_spec(api, data, lr))
    jdet = jspec.data.model
    params0 = [from_numpy_tree(jax.tree.map(
        np.asarray, jdet.init_params(jax.random.PRNGKey(s))), device="cpu")
        for s in tspec.seeds.seeds]
    (want,) = JX.execute(JX.plan(jspec)).results
    (got,) = T.execute(T.plan(tspec), params0=params0, device="cpu").results
    rounds = want.loss_curves.shape[1]
    firsts = []
    for r in (want, got):
        bad = ~np.isfinite(r.loss_curves)
        first = [int(np.flatnonzero(row)[0]) if row.any() else rounds
                 for row in bad]
        assert all(bad[b, f:].all() for b, f in enumerate(first))
        firsts.append(first)
    assert firsts[1] == firsts[0]
    diverged = sum(f < rounds for f in firsts[0])
    if lr == 1e-3:
        assert 0 < diverged < len(firsts[0])
    else:
        assert diverged == 0
    for b, f in enumerate(firsts[0]):
        curve = want.loss_curves[b]
        over = np.flatnonzero(~(curve[:f] <= curve[0]))
        n = int(over[0]) if over.size else f
        np.testing.assert_allclose(got.loss_curves[b, :n], curve[:n],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.auroc_used, want.auroc_used, rtol=0,
                               atol=AUROC_ATOL)

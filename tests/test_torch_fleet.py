"""The port's fleet layer (``repro_torch.sim``, ``core/events.py``,
``core/sim_session.py``) against the JAX package's.

The fleet simulator is numpy-only and seeded, so the two packages'
records are equal field for field, event streams included, once both
run with the same overheads.  The port's ``OVERHEADS`` come from the
card's seam probe and the JAX package's from its own, so the port's
scenarios are given the JAX package's overheads for the comparison;
with its own, the port must still show the fleet demo's claims.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.sim as jsim  # noqa: E402
import repro.sim.scenarios as jscen  # noqa: E402
import repro_torch.sim as psim  # noqa: E402
import repro_torch.sim.scenarios as pscen  # noqa: E402

#: the JAX package's probe, rebuilt by the port's function
SAME = pscen.overheads_from_probe(jscen.SEAM_PROBE)


def _pairs():
    jax_worlds = (*jscen.default_scenarios(0), *jscen.queued_scenarios(0))
    port_worlds = (*pscen.default_scenarios(0), *pscen.queued_scenarios(0))
    return list(zip(jax_worlds, port_worlds))


PAIRS = _pairs()
#: the queued worlds under the scheduler × fleet-policy pairings of
#: ``tests/test_fleet.py::test_queued_fleet_bit_deterministic``
PAIRINGS = (("fill", "adapt"), ("fifo", "token"))


def _records(jsc, psc, policy, **kw):
    psc = dataclasses.replace(psc, overheads=SAME)
    assert dataclasses.asdict(psc.overheads) \
        == dataclasses.asdict(jsc.overheads)
    want = jsim.FleetSim(jsc, jsim.POLICY_FACTORIES[policy], **kw).run()
    got = psim.FleetSim(psc, psim.POLICY_FACTORIES[policy], **kw).run()
    return dataclasses.asdict(want), dataclasses.asdict(got)


@pytest.mark.parametrize("policy", sorted(jsim.POLICY_FACTORIES))
@pytest.mark.parametrize("pair", PAIRS, ids=[j.name for j, _ in PAIRS])
def test_fleet_record_equals_jax(pair, policy):
    jsc, psc = pair
    assert jsc.name == psc.name
    want, got = _records(jsc, psc, policy, seed=0)
    assert got == want
    assert any(job["events"] for job in got["jobs"])


QUEUED = [(j, p) for j, p in PAIRS if j.scheduler != "immediate"]


@pytest.mark.parametrize("sched,fleet_policy", PAIRINGS)
@pytest.mark.parametrize("pair", QUEUED, ids=[j.name for j, _ in QUEUED])
def test_queued_fleet_pairings_equal_jax(pair, sched, fleet_policy):
    jsc, psc = pair
    want, got = _records(jsc, psc, "react", seed=7, scheduler=sched,
                         fleet_policy=fleet_policy)
    assert got == want
    assert got["scheduler"] == sched and got["fleet_policy"] == fleet_policy
    assert got["fleet_events"]


def test_seeded_runs_are_bit_identical():
    from repro_torch.sim.scenarios import multi_tenant_rush, overload_ramp

    for sc, kw in ((overload_ramp(0), {}),
                   (multi_tenant_rush(0, n_jobs=14),
                    dict(scheduler="fill", fleet_policy="adapt"))):
        a = psim.FleetSim(sc, psim.POLICY_FACTORIES["plan"], seed=3,
                          **kw).run()
        b = psim.FleetSim(sc, psim.POLICY_FACTORIES["plan"], seed=3,
                          **kw).run()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_card_overheads_keep_the_demo_claims():
    """With the port's own ``OVERHEADS`` (the card's seam probe), the
    deadline-aware policy rescues the overload ramp at a lower cost
    than always-burst, and retires the cloud pod after a spike."""
    assert pscen.overload_ramp(0).overheads == pscen.OVERHEADS
    assert pscen.OVERHEADS == pscen.overheads_from_probe(pscen.SEAM_PROBE)
    recs = {name: psim.FleetSim(pscen.overload_ramp(0), pf, seed=0).run()
            for name, pf in psim.POLICY_FACTORIES.items()}
    assert recs["plan"].hit_rate > recs["no-burst"].hit_rate
    assert recs["plan"].cloud_cost < recs["always-burst"].cloud_cost
    spike = psim.FleetSim(pscen.transient_spike(0),
                          psim.POLICY_FACTORIES["plan"], seed=0).run()
    assert spike.cloud_timeline[-1][1] == 0

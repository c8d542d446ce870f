"""The PyTorch port's schedule model and its generators against the JAX
package's, exactly (integers and strings, no tolerance).

Every named family over a handful of seeds and ``random_schedule`` over 20
seeds give the same JSON text in both packages, the same derived views
(membership phases, expected and removed slots, adversarial crossings,
engine compatibility) and the same shrink candidates; schedules cross
between the packages through JSON both ways; ``validate`` raises the same
``ScheduleError`` text on malformed schedules; and the helpers the chaos
compiler reads (``endpoints_for``, the hier cohort geometry,
``loss_as_engine_delivery``, ``Settings``) are equal. No engine runs here.
"""

import dataclasses

import pytest

from rapid_tpu.settings import Settings as JaxSettings
from rapid_tpu.sim import faults as jfaults
from rapid_tpu.sim import fuzz as jfuzz
from rapid_tpu.sim import scenario as jscenario
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.sim import faults, fuzz, scenario

FAMILY_SEEDS = [(family, seed) for family in jfuzz.FAMILIES for seed in (0, 1, 3, 7, 20)]
RANDOM_SEEDS = list(range(20))


def both(family, seed):
    """(JAX schedule, port schedule) of a named family, or of
    ``random_schedule`` when ``family`` is None."""
    if family is None:
        return jfuzz.random_schedule(seed), fuzz.random_schedule(seed)
    return jfuzz.scenario_family(family, seed), fuzz.scenario_family(family, seed)


def as_tuples(groups):
    return [[(e.kind, e.slots, e.args, e.dwell_ms, e.settle) for e in g] for g in groups]


def views(schedule):
    return (
        as_tuples(schedule.membership_phases()),
        schedule.expected_members(),
        sorted(schedule.expected_removed_slots()),
        sorted(schedule.ever_removed_slots()),
        schedule.adversarial_crossings(),
        schedule.engine_compatible,
    )


def test_family_registry_is_jax():
    assert list(fuzz.FAMILIES) == list(jfuzz.FAMILIES)
    assert (fuzz.N0, fuzz.N_SLOTS) == (jfuzz.N0, jfuzz.N_SLOTS)
    with pytest.raises(faults.ScheduleError) as port_err:
        fuzz.scenario_family("no_such_family", 0)
    with pytest.raises(jfaults.ScheduleError) as jax_err:
        jfuzz.scenario_family("no_such_family", 0)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "family,seed", FAMILY_SEEDS + [(None, s) for s in RANDOM_SEEDS],
    ids=lambda x: "random" if x is None else str(x),
)
def test_schedules_views_and_shrink_candidates_are_jax(family, seed):
    jax_schedule, schedule = both(family, seed)
    assert schedule.to_json() == jax_schedule.to_json()
    schedule.validate()
    assert views(schedule) == views(jax_schedule)
    candidates = [c.to_json() for c in fuzz._shrink_candidates(schedule)]
    assert candidates == [c.to_json() for c in jfuzz._shrink_candidates(jax_schedule)]
    assert candidates  # every family carries events to reduce


@pytest.mark.parametrize("family,seed", FAMILY_SEEDS[::5] + [(None, 4), (None, 11)])
def test_schedules_cross_between_the_packages_through_json(family, seed):
    jax_schedule, schedule = both(family, seed)
    from_jax = faults.FaultSchedule.from_json(jax_schedule.to_json())
    assert from_jax == schedule
    assert from_jax.to_json() == jax_schedule.to_json()
    from_port = jfaults.FaultSchedule.from_json(schedule.to_json())
    assert from_port == jax_schedule
    assert views(from_port) == views(from_jax)


def _malformed():
    """(name, schedule kwargs) of schedules ``validate`` must reject."""
    e = faults.FaultEvent
    return [
        ("bad_n0", dict(n0=0, n_slots=4)),
        ("n0_past_slots", dict(n0=5, n_slots=4)),
        ("unknown_profile", dict(n0=4, n_slots=6, profile="mesh")),
        ("typod_drop_message", dict(n0=4, n_slots=6, events=[
            e("drop_first_n", (1,), {"message": "probes", "count": 2})])),
        ("repause", dict(n0=4, n_slots=6, events=[
            e("clock_pause", (2,)), e("clock_pause", (2,))])),
        ("skew_paused", dict(n0=4, n_slots=6, events=[
            e("clock_pause", (2,)), e("clock_skew", (2,), {"offset_ms": 5.0})])),
        ("seed_crash", dict(n0=4, n_slots=6, events=[e("crash", (0,))])),
        ("join_live", dict(n0=4, n_slots=6, events=[e("join", (2,))])),
        ("restart_live", dict(n0=4, n_slots=6, events=[e("restart", (2,))])),
        ("lie_about_self", dict(n0=4, n_slots=6, events=[
            e("false_alert", (2,), {"subject": 2, "rings": [0]})])),
        ("ring_out_of_range", dict(n0=4, n_slots=6, events=[
            e("false_alert", (1,), {"subject": 2, "rings": [10]})])),
        ("flat_committee", dict(n0=4, n_slots=6, events=[
            e("committee_crash", (2,), settle=False), e("crash", (3,))])),
        ("unsettled_last", dict(n0=4, n_slots=6, events=[e("crash", (2,), settle=False)])),
        ("loss_permille", dict(n0=4, n_slots=6, events=[e("loss", args={"permille": 1001})])),
        ("negative_dwell", dict(n0=4, n_slots=6, events=[e("crash", (2,), dwell_ms=-1.0)])),
    ]


@pytest.mark.parametrize("name,kwargs", _malformed(), ids=[m[0] for m in _malformed()])
def test_validate_raises_jax_text(name, kwargs):
    schedule = faults.FaultSchedule(**kwargs)
    jax_kwargs = dict(kwargs)
    jax_kwargs["events"] = [
        jfaults.FaultEvent(e.kind, e.slots, dict(e.args), e.dwell_ms, e.settle)
        for e in kwargs.get("events", [])
    ]
    with pytest.raises(faults.ScheduleError) as port_err:
        schedule.validate()
    with pytest.raises(jfaults.ScheduleError) as jax_err:
        jfaults.FaultSchedule(**jax_kwargs).validate()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("text", [
    '{"version": 2, "n0": 4, "n_slots": 6}',
    '{"n_slots": 6}',
    '{"n0": 4, "n_slots": 6, "events": [{"kind": "crash", "slots": ["x"]}]}',
])
def test_from_json_raises_jax_text(text):
    with pytest.raises(faults.ScheduleError) as port_err:
        faults.FaultSchedule.from_json(text)
    with pytest.raises(jfaults.ScheduleError) as jax_err:
        jfaults.FaultSchedule.from_json(text)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", [0, 3, 17, 249, 250, 513])
def test_endpoints_and_hier_geometry_are_jax(seed):
    got = [(ep.hostname, ep.port) for ep in scenario.endpoints_for(seed, fuzz.N_SLOTS)]
    want = [(ep.hostname, ep.port) for ep in jscenario.endpoints_for(seed, jfuzz.N_SLOTS)]
    assert got == want
    cmap, endpoints, slot_of = fuzz.hier_geometry(seed)
    jmap, jendpoints, jslot_of = jfuzz.hier_geometry(seed)
    assert cmap.n_cohorts == jmap.n_cohorts == 2
    assert cmap.to_dict() == jmap.to_dict()
    assert [str(ep) for ep in cmap.committee()] == [str(ep) for ep in jmap.committee()]
    assert [cmap.cohort_of(ep) for ep in endpoints] == [jmap.cohort_of(ep) for ep in jendpoints]
    assert [cmap.is_member(ep) for ep in endpoints] == [jmap.is_member(ep) for ep in jendpoints]
    assert {str(ep): s for ep, s in slot_of.items()} == {str(ep): s for ep, s in jslot_of.items()}


@pytest.mark.parametrize("permille,horizon", [(0, 2), (50, 2), (1000, 3), (7, 1)])
def test_loss_as_engine_delivery_is_jax(permille, horizon):
    assert faults.loss_as_engine_delivery(permille, horizon) == jfaults.loss_as_engine_delivery(
        permille, horizon)


def test_loss_as_engine_delivery_raises_jax_text():
    with pytest.raises(faults.ScheduleError) as port_err:
        faults.loss_as_engine_delivery(1001)
    with pytest.raises(jfaults.ScheduleError) as jax_err:
        jfaults.loss_as_engine_delivery(1001)
    assert str(port_err.value) == str(jax_err.value)


def test_settings_and_watermarks_are_jax():
    port, ref = dataclasses.asdict(Settings()), dataclasses.asdict(JaxSettings())
    assert list(port) == list(ref) and port == ref
    assert (faults.WATERMARK_K, faults.WATERMARK_H, faults.WATERMARK_L) == (
        jfaults.WATERMARK_K, jfaults.WATERMARK_H, jfaults.WATERMARK_L)
    assert dataclasses.asdict(scenario.hier_sim_settings()) == dataclasses.asdict(
        jscenario.hier_sim_settings())
    assert scenario.HIER_SIM_COHORT_SIZE == jscenario.HIER_SIM_COHORT_SIZE
    # Name -> message class, each the port's own type of JAX's name.
    assert {name: cls.__name__ for name, cls in faults.DROPPABLE_MESSAGES.items()} == {
        name: cls.__name__ for name, cls in jfaults.DROPPABLE_MESSAGES.items()}
    assert all(cls.__module__ == "rapid_tpu_torch.types"
               for cls in faults.DROPPABLE_MESSAGES.values())
    assert (faults.MEMBERSHIP_KINDS, faults.ENVIRONMENT_KINDS, faults.ADVERSARIAL_KINDS) == (
        jfaults.MEMBERSHIP_KINDS, jfaults.ENVIRONMENT_KINDS, jfaults.ADVERSARIAL_KINDS)
    assert faults.MEMBER_DELTA == jfaults.MEMBER_DELTA
    for bad in (dict(k=10, h=4, l=9), dict(topology="mesh"), dict(hier_target_cohort_size=1)):
        with pytest.raises(ValueError) as port_err:
            Settings(**bad).validate()
        with pytest.raises(ValueError) as jax_err:
            JaxSettings(**bad).validate()
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", [0, 5])
def test_schedule_rng_is_jax(seed):
    port = faults.schedule_rng(fuzz.random_schedule(seed))
    ref = jfaults.schedule_rng(jfuzz.random_schedule(seed))
    assert [port.random() for _ in range(8)] == [ref.random() for _ in range(8)]

"""Engine state: N virtual membership endpoints as struct-of-arrays (port of
``rapid_tpu/models/state.py``).

Every lane has the JAX package's shape and, under the config's compaction
policy (:func:`compaction_policy`: the wide layout at ``compact=0``, the
narrowest legal dtypes at ``compact=1``), its dtype. Lanes are stored by
the port's rules: uint32 as int32 bit patterns (:mod:`rapid_tpu_torch._u32`),
uint16 as int16 bit patterns and every other dtype as itself
(:mod:`rapid_tpu_torch._narrow`). Scalars are 0-d tensors on the state's
device, so a round never reads them back unless it branches on them.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rapid_tpu_torch import _narrow
from rapid_tpu_torch.ops.hashing import masked_set_hash
from rapid_tpu_torch.ops.kernels import per_batch
from rapid_tpu_torch.ops.rings import ring_perms, ring_topology_from_perm

#: Sentinel fire round of an edge whose alert has not fired (wide layout).
FIRE_NEVER = 1 << 30
#: The sentinel of the compact layout's int16 fire rounds: a fire round is
#: real (at most :data:`ROUND_ENVELOPE`) or this, so ``round_idx -
#: sentinel`` stays negative for every in-envelope round.
FIRE_NEVER_NARROW = 1 << 14
#: Rounds one configuration may run under the compact layout before the
#: int16 fire round loses the fired / unfired distinction. Every view change
#: resets ``round_idx`` to 0.
ROUND_ENVELOPE = FIRE_NEVER_NARROW - 1


class EngineConfig(NamedTuple):
    """Static engine parameters: the JAX package's fields, in its order
    (checkpoints store the config positionally)."""

    n: int  # padded virtual-node slots
    k: int  # rings
    h: int  # high watermark
    l: int  # low watermark
    c: int = 2  # receiver cohorts
    fd_threshold: int = 3  # consecutive failed probe windows before alerting
    # Kept for positional parity. In the port the device decides: the
    # delivery kernel runs whenever the state lies on a CUDA device.
    use_pallas: bool = False
    # Rounds an announced proposal may sit undecided before the classic
    # fallback fires.
    fallback_rounds: int = 8
    # Max extra rounds of per-(cohort, edge) alert delivery delay.
    delivery_spread: int = 0
    # Coordinators racing per classic-fallback attempt.
    concurrent_coordinators: int = 1
    # 0 = cumulative failure counter; W in [1, 32] = windowed policy.
    fd_window: int = 0
    # Probability (permille) that a delivery draws a nonzero delay; 1000 is
    # the legacy uniform [0, delivery_spread] draw.
    delivery_prob_permille: int = 1000
    # Tile width of the TPU kernel; kept for positional parity, unused here.
    pallas_lanes: int = 128
    # 0 = the wide int32/uint32 layout; 1 = every lane of NARROWABLE_LANES
    # at the narrowest legal dtype (:func:`compaction_policy`), bit for bit
    # the same protocol within the envelopes (ROUND_ENVELOPE rounds, fewer
    # than 2**15 - 1 classic attempts and fd events per configuration).
    compact: int = 0
    # 1 = carry the device telemetry plane (:class:`TelemetryLanes`).
    telemetry: int = 0
    # R > 0 = carry the device round-trace ring of the last R rounds
    # (:class:`TraceRing`); needs ``telemetry``.
    trace: int = 0


class CompactionPolicy(NamedTuple):
    """Per-lane-kind numpy dtype NAMES, a pure function of the config
    (:func:`compaction_policy`), with ``fire_never`` the unfired-edge
    sentinel legal at the ``round`` dtype. Kinds: ``idx`` (ring and rank
    indices in ``[-1, n-1]`` plus n itself), ``cohort`` (in ``[-1, c-1]``
    plus c), ``counter`` (fd counts, classic ranks and epochs, rounds
    undecided), ``hist`` (the fd bit-history, ``fd_window`` bits),
    ``report`` (ring bitmasks, K bits; uint32 under ``use_pallas``, as the
    JAX package keeps it for its kernel's words) and ``round`` (fire
    rounds)."""

    idx: str
    cohort: str
    counter: str
    hist: str
    report: str
    round: str
    fire_never: int


#: The wide layout: the differential oracle of the compact one.
WIDE_POLICY = CompactionPolicy(
    idx="int32", cohort="int32", counter="int32", hist="uint32",
    report="uint32", round="int32", fire_never=FIRE_NEVER,
)

#: The EngineState lanes the compact policy may store below 32 bits.
NARROWABLE_LANES = frozenset({
    "ring_perm", "obs_idx", "subj_idx", "inval_obs", "cohort_of",
    "fd_count", "fd_hist", "fire_round", "report_bits",
    "cp_rnd_r", "cp_rnd_i", "cp_vrnd_r", "cp_vrnd_i", "cp_vval_src",
    "classic_epoch", "rounds_undecided",
})


def min_index_dtype(n: int) -> str:
    """Smallest signed dtype holding indices in ``[-1, n-1]`` AND the count
    ``n`` itself (the JAX package's index normalization materializes n in
    the index dtype)."""
    if n < 1 << 7:
        return "int8"
    if n < 1 << 15:
        return "int16"
    return "int32"


def _min_bits_dtype(bits: int) -> str:
    """Smallest unsigned dtype holding a ``bits``-wide bitmask."""
    if bits <= 8:
        return "uint8"
    if bits <= 16:
        return "uint16"
    return "uint32"


def compaction_policy(cfg: "EngineConfig") -> CompactionPolicy:
    """The config -> dtype derivation: :data:`WIDE_POLICY` at ``compact=0``,
    else every kind at its narrowest legal dtype."""
    if not cfg.compact:
        return WIDE_POLICY
    return CompactionPolicy(
        idx=min_index_dtype(cfg.n),
        cohort=min_index_dtype(cfg.c),
        counter="int16",
        # Counter mode (fd_window 0) leaves fd_hist unused: stored narrowest.
        hist=_min_bits_dtype(max(cfg.fd_window, 1)),
        report="uint32" if cfg.use_pallas else _min_bits_dtype(cfg.k),
        round="int16",
        fire_never=FIRE_NEVER_NARROW,
    )


#: field -> (shape symbols over (n, k, c), policy kind) of every
#: EngineState and FaultInputs lane, the JAX package's table. The kinds
#: "uint32", "int32" and "bool" are fixed-width; the others are
#: :class:`CompactionPolicy` fields.
LANE_SPECS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    # EngineState
    "key_hi": (("k", "n"), "uint32"),
    "key_lo": (("k", "n"), "uint32"),
    "ring_perm": (("k", "n"), "idx"),
    "id_hi": (("n",), "uint32"),
    "id_lo": (("n",), "uint32"),
    "alive": (("n",), "bool"),
    "obs_idx": (("k", "n"), "idx"),
    "subj_idx": (("k", "n"), "idx"),
    "inval_obs": (("k", "n"), "idx"),
    "config_epoch": ((), "int32"),
    "config_hi": ((), "uint32"),
    "config_lo": ((), "uint32"),
    "n_members": ((), "int32"),
    "fd_count": (("n", "k"), "counter"),
    "fd_hist": (("n", "k"), "hist"),
    "fd_fired": (("n", "k"), "bool"),
    "fire_round": (("n", "k"), "round"),
    "join_pending": (("n",), "bool"),
    "cohort_of": (("n",), "cohort"),
    "report_bits": (("c", "n"), "report"),
    "seen_down": (("c",), "bool"),
    "released": (("c", "n"), "bool"),
    "announced": (("c",), "bool"),
    "prop_mask": (("c", "n"), "bool"),
    "prop_hi": (("c",), "uint32"),
    "prop_lo": (("c",), "uint32"),
    "vote_hi": (("n",), "uint32"),
    "vote_lo": (("n",), "uint32"),
    "vote_valid": (("n",), "bool"),
    "rounds_undecided": ((), "counter"),
    "cp_rnd_r": (("n",), "counter"),
    "cp_rnd_i": (("n",), "idx"),
    "cp_vrnd_r": (("n",), "counter"),
    "cp_vrnd_i": (("n",), "idx"),
    "cp_vval_src": (("n",), "cohort"),
    "classic_epoch": ((), "counter"),
    "round_idx": ((), "int32"),
    "retired": (("n",), "bool"),
    # FaultInputs
    "crashed": (("n",), "bool"),
    "probe_fail": (("n", "k"), "bool"),
    "rx_block": (("c", "n"), "bool"),
}

#: The StepEvents lanes it does not share with EngineState; fixed dtypes.
EVENT_LANE_SPECS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "decided": ((), "bool"),
    "fast_decided": ((), "bool"),
    "winner_mask": (("n",), "bool"),
    "proposals_announced": (("c",), "bool"),
    "alerts_emitted": ((), "int32"),
    "total_votes": ((), "int32"),
    "max_votes": ((), "int32"),
}

#: Lane kinds whose values are unsigned bit patterns.
UNSIGNED_KINDS = frozenset({"uint32", "hist", "report"})


def lane_dtypes(cfg: "EngineConfig") -> Dict[str, str]:
    """field -> numpy dtype name under ``cfg``'s policy, for every
    EngineState and FaultInputs lane."""
    pol = compaction_policy(cfg)._asdict()
    return {field: pol.get(kind, kind) for field, (_, kind) in LANE_SPECS.items()}


def lane_storage(cfg: "EngineConfig") -> Dict[str, torch.dtype]:
    """field -> the torch dtype that stores it under ``cfg``'s policy."""
    return {field: _narrow.STORAGE[name] for field, name in lane_dtypes(cfg).items()}


class EngineState(NamedTuple):
    """Device state for one virtual cluster (all lanes padded to n slots;
    see :data:`LANE_SPECS` for shapes and kinds)."""

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    ring_perm: torch.Tensor
    id_hi: torch.Tensor
    id_lo: torch.Tensor
    alive: torch.Tensor
    obs_idx: torch.Tensor
    subj_idx: torch.Tensor
    inval_obs: torch.Tensor
    config_epoch: torch.Tensor
    config_hi: torch.Tensor
    config_lo: torch.Tensor
    n_members: torch.Tensor
    fd_count: torch.Tensor
    fd_hist: torch.Tensor
    fd_fired: torch.Tensor
    fire_round: torch.Tensor
    join_pending: torch.Tensor
    cohort_of: torch.Tensor
    report_bits: torch.Tensor
    seen_down: torch.Tensor
    released: torch.Tensor
    announced: torch.Tensor
    prop_mask: torch.Tensor
    prop_hi: torch.Tensor
    prop_lo: torch.Tensor
    vote_hi: torch.Tensor
    vote_lo: torch.Tensor
    vote_valid: torch.Tensor
    rounds_undecided: torch.Tensor
    cp_rnd_r: torch.Tensor
    cp_rnd_i: torch.Tensor
    cp_vrnd_r: torch.Tensor
    cp_vrnd_i: torch.Tensor
    cp_vval_src: torch.Tensor
    classic_epoch: torch.Tensor
    round_idx: torch.Tensor
    retired: torch.Tensor


class FaultInputs(NamedTuple):
    """Fault-injection masks."""

    crashed: torch.Tensor  # [n] bool — unresponsive; never votes or alerts
    probe_fail: torch.Tensor  # [n, k] bool — extra per-edge probe failures
    rx_block: torch.Tensor  # [c, n] bool — cohort c cannot hear from slot i

    @staticmethod
    def none(cfg: EngineConfig, device) -> "FaultInputs":
        return FaultInputs(
            crashed=torch.zeros((cfg.n,), dtype=torch.bool, device=device),
            probe_fail=torch.zeros((cfg.n, cfg.k), dtype=torch.bool, device=device),
            rx_block=torch.zeros((cfg.c, cfg.n), dtype=torch.bool, device=device),
        )


class StepEvents(NamedTuple):
    """Observable outcomes of one engine round."""

    decided: torch.Tensor  # 0-d bool
    fast_decided: torch.Tensor  # 0-d bool — the fast round decided
    winner_mask: torch.Tensor  # [n] bool — the decided cut
    proposals_announced: torch.Tensor  # [c] bool
    alerts_emitted: torch.Tensor  # 0-d int32
    total_votes: torch.Tensor  # 0-d int32
    max_votes: torch.Tensor  # 0-d int32
    prop_hi: torch.Tensor  # [c] stored uint32, before any view-change reset
    prop_lo: torch.Tensor  # [c] stored uint32


#: Log2 bucket count of the rounds-undecided histogram: bucket b counts
#: decisions that sat undecided for r rounds with floor(log2(max(r, 1)))
#: == b, clamped into the last bucket.
TELEMETRY_BUCKETS = 8

#: field -> shape symbols over (n, k, c, b), ``b`` = :data:`TELEMETRY_BUCKETS`.
#: Every telemetry lane is int32 (accumulators, never narrowed).
TELEMETRY_LANE_SPECS: Dict[str, Tuple[str, ...]] = {
    "tl_rounds": (),
    "tl_alerts": (),
    "tl_active": ("c", "n"),
    "tl_invalidated": ("c", "n"),
    "tl_proposals": ("c",),
    "tl_tally_sum": (),
    "tl_fast_decisions": (),
    "tl_classic_decisions": (),
    "tl_conflict_rounds": (),
    "tl_undecided_hist": ("b",),
}


class TelemetryLanes(NamedTuple):
    """On-device activity, tally, conflict and decision-path accumulators,
    carried beside :class:`EngineState` through every round when
    ``EngineConfig.telemetry == 1``. The round writes them and never reads
    them; the drivers read them only at ``sync()``, through the digests. A
    fleet's lanes carry a leading tenant axis."""

    tl_rounds: torch.Tensor  # [] rounds stepped
    tl_alerts: torch.Tensor  # [] edge alerts applied (sum of alerts_emitted)
    # Rounds each (cohort, subject) slot was active: nonzero report bits or
    # a watermark tally in the [L, H) flux band.
    tl_active: torch.Tensor  # [c, n]
    tl_invalidated: torch.Tensor  # [c, n] implicit-invalidation events
    tl_proposals: torch.Tensor  # [c] proposals released per cohort
    tl_tally_sum: torch.Tensor  # [] winning-tally sizes, summed at decisions
    tl_fast_decisions: torch.Tensor  # [] fast-path decisions
    tl_classic_decisions: torch.Tensor  # [] classic-fallback decisions
    # Rounds where some cohort had announced and the fast path did not decide.
    tl_conflict_rounds: torch.Tensor  # []
    tl_undecided_hist: torch.Tensor  # [TELEMETRY_BUCKETS] log2(rounds undecided) at decision


#: field -> shape symbols over (r,), ``r`` = ``EngineConfig.trace``. Every
#: ring lane is int32.
TRACE_LANE_SPECS: Dict[str, Tuple[str, ...]] = {
    "tr_round": ("r",),
    "tr_epoch": ("r",),
    "tr_active": ("r",),
    "tr_alerts": ("r",),
    "tr_proposals": ("r",),
    "tr_tally": ("r",),
    "tr_path": ("r",),
    "tr_conflict": ("r",),
    "tr_undecided": ("r",),
    "tr_cursor": (),
    "tr_wraps": (),
}


class TraceRing(NamedTuple):
    """A device-resident record of the last ``EngineConfig.trace`` = R
    rounds, one slot per round, written by the round body and read only at
    ``sync()`` (the telemetry plane's discipline; ``trace > 0`` needs
    ``telemetry``).

    ``tr_cursor`` counts records ever written; a round lands in slot
    ``tr_cursor % R``. ``tr_wraps`` counts writes into slot R - 1, so
    ``tr_wraps == tr_cursor // R`` and ``tr_cursor == tl_rounds``. A fleet
    gates the ring with the lanes it refines: a frozen tenant's cursor
    holds still."""

    tr_round: torch.Tensor  # [R] round_idx the round started with
    tr_epoch: torch.Tensor  # [R] config_epoch the round ran in
    tr_active: torch.Tensor  # [R] active (cohort, subject) slots
    tr_alerts: torch.Tensor  # [R] edge alerts applied
    tr_proposals: torch.Tensor  # [R] proposals released
    tr_tally: torch.Tensor  # [R] winning-tally size (0 unless decided)
    tr_path: torch.Tensor  # [R] decision path: 0 none, 1 fast, 2 classic
    tr_conflict: torch.Tensor  # [R] announced-but-no-fast-decision flag
    # [R] rounds_undecided AFTER the round's update (the JAX engine stores
    # this value; its field comment says "entering the round").
    tr_undecided: torch.Tensor
    tr_cursor: torch.Tensor  # [] records ever written
    tr_wraps: torch.Tensor  # [] writes into slot R - 1


def lane_dims(cfg: EngineConfig) -> Dict[str, int]:
    """The size of each shape symbol of :data:`LANE_SPECS`,
    :data:`TELEMETRY_LANE_SPECS` and :data:`TRACE_LANE_SPECS` under ``cfg``."""
    return {"n": cfg.n, "k": cfg.k, "c": cfg.c, "b": TELEMETRY_BUCKETS, "r": cfg.trace}


def _zero_lanes(cls, specs, cfg: EngineConfig, device, tenants) -> NamedTuple:
    dims = lane_dims(cfg)
    lead = () if tenants is None else (tenants,)
    return cls(**{
        field: torch.zeros(lead + tuple(dims[s] for s in shape), dtype=torch.int32, device=device)
        for field, shape in specs.items()
    })


def _lanes_bytes(specs, cfg: EngineConfig) -> int:
    dims = lane_dims(cfg)
    return sum(4 * math.prod(dims[s] for s in shape) for shape in specs.values())


def initial_telemetry(cfg: EngineConfig, device, tenants: Optional[int] = None) -> TelemetryLanes:
    """All-zero telemetry lanes on ``device``; with ``tenants=t`` a
    fleet's, every lane ``[t, ...]``."""
    return _zero_lanes(TelemetryLanes, TELEMETRY_LANE_SPECS, cfg, device, tenants)


def telemetry_bytes_total(cfg: EngineConfig) -> int:
    """At-rest bytes of one cluster's telemetry lanes (all int32)."""
    return _lanes_bytes(TELEMETRY_LANE_SPECS, cfg)


def initial_trace(cfg: EngineConfig, device, tenants: Optional[int] = None) -> TraceRing:
    """An all-zero trace ring of capacity ``cfg.trace`` on ``device``; with
    ``tenants=t`` a fleet's."""
    return _zero_lanes(TraceRing, TRACE_LANE_SPECS, cfg, device, tenants)


def trace_bytes_total(cfg: EngineConfig) -> int:
    """At-rest bytes of one cluster's trace ring (all int32)."""
    return _lanes_bytes(TRACE_LANE_SPECS, cfg)


def map_lanes(fn, tree):
    """``fn`` applied to every lane of an :class:`EngineState`,
    :class:`FaultInputs`, :class:`StepEvents`, :class:`TelemetryLanes` or
    :class:`TraceRing`; a tree of the same type. ``None`` (a plane that is
    off) stays ``None``."""
    return None if tree is None else type(tree)(*map(fn, tree))


def stack_lanes(trees):
    """B same-shape trees (states, fault masks, events or plane lanes)
    stacked lane by lane along a new leading tenant axis (the JAX package's
    ``stack_pytrees``); ``None`` for planes that are off."""
    if trees[0] is None:
        return None
    return type(trees[0])(*(torch.stack(lanes) for lanes in zip(*trees)))


def select_lanes(cond: torch.Tensor, new, old):
    """Per-tenant select over whole trees: lane by lane, tenant i takes
    ``new`` where ``cond[i]`` and ``old`` elsewhere (what ``jax.vmap``
    makes of a ``lax.cond`` or a frozen ``fori_loop`` lane). ``None`` (a
    plane that is off) stays ``None``."""
    if new is None:
        return None
    return type(new)(
        *(torch.where(per_batch(cond, a), a, b) for a, b in zip(new, old))
    )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but no card is available (pass device='cpu')")
    return dev


def validate_config(cfg: EngineConfig) -> None:
    """The JAX package's config checks (with its ``VirtualCluster``
    construction checks on ``trace``)."""
    if cfg.compact not in (0, 1):
        raise ValueError(f"compact must be 0 (wide) or 1 (compact), got {cfg.compact}")
    if cfg.trace and not cfg.telemetry:
        raise ValueError(
            "EngineConfig.trace requires telemetry: the round-trace ring "
            "refines the telemetry plane (pass telemetry=True)"
        )
    if cfg.trace < 0:
        raise ValueError(f"trace capacity must be >= 0, got {cfg.trace}")
    if not 1 <= cfg.k <= 32:
        raise ValueError(f"K must be in [1, 32]: ring reports are uint32 bitmasks (got K={cfg.k})")
    if cfg.c > 1024:
        raise ValueError(f"at most 1024 receiver cohorts, got {cfg.c}")
    if cfg.delivery_spread < 0:
        raise ValueError(f"delivery_spread must be >= 0, got {cfg.delivery_spread}")
    if not 0 <= cfg.delivery_prob_permille <= 1000:
        raise ValueError(
            f"delivery_prob_permille must be in [0, 1000], got {cfg.delivery_prob_permille}"
        )
    if not 0 <= cfg.fd_window <= 32:
        raise ValueError(f"fd_window must be 0 (counter mode) or 1..32, got {cfg.fd_window}")
    if cfg.fd_window and cfg.fd_threshold > cfg.fd_window:
        raise ValueError(
            f"fd_threshold ({cfg.fd_threshold}) cannot exceed fd_window "
            f"({cfg.fd_window}): the edge could never fire"
        )


def _i32(value: int, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def initial_state(cfg: EngineConfig, key_hi, key_lo, id_hi, id_lo, alive) -> EngineState:
    """A configuration-consistent state from identity lanes (stored uint32
    tensors) and the alive mask, all on one device, every lane at ``cfg``'s
    policy dtype."""
    validate_config(cfg)
    dev = alive.device
    n, k, c = cfg.n, cfg.k, cfg.c
    st = lane_storage(cfg)
    # The one sort: every later topology is O(N) scans over these perms.
    perm = ring_perms(key_hi, key_lo).to(st["ring_perm"])
    topo = ring_topology_from_perm(perm, alive)
    config_hi, config_lo = masked_set_hash(id_hi, id_lo, alive)

    def zeros(field, shape):
        return torch.zeros(shape, dtype=st[field], device=dev)

    return EngineState(
        key_hi=key_hi,
        key_lo=key_lo,
        ring_perm=perm,
        id_hi=id_hi,
        id_lo=id_lo,
        alive=alive,
        obs_idx=topo.obs_idx.to(st["obs_idx"]),
        subj_idx=topo.subj_idx.to(st["subj_idx"]),
        inval_obs=topo.obs_idx.to(st["inval_obs"]),
        config_epoch=_i32(0, dev),
        config_hi=config_hi,
        config_lo=config_lo,
        n_members=alive.sum(dtype=torch.int32),
        fd_count=zeros("fd_count", (n, k)),
        fd_hist=zeros("fd_hist", (n, k)),
        fd_fired=zeros("fd_fired", (n, k)),
        fire_round=torch.full(
            (n, k), compaction_policy(cfg).fire_never, dtype=st["fire_round"], device=dev
        ),
        join_pending=zeros("join_pending", (n,)),
        cohort_of=zeros("cohort_of", (n,)),
        report_bits=zeros("report_bits", (c, n)),
        seen_down=zeros("seen_down", (c,)),
        released=zeros("released", (c, n)),
        announced=zeros("announced", (c,)),
        prop_mask=zeros("prop_mask", (c, n)),
        prop_hi=zeros("prop_hi", (c,)),
        prop_lo=zeros("prop_lo", (c,)),
        vote_hi=zeros("vote_hi", (n,)),
        vote_lo=zeros("vote_lo", (n,)),
        vote_valid=zeros("vote_valid", (n,)),
        rounds_undecided=zeros("rounds_undecided", ()),
        cp_rnd_r=zeros("cp_rnd_r", (n,)),
        cp_rnd_i=zeros("cp_rnd_i", (n,)),
        cp_vrnd_r=zeros("cp_vrnd_r", (n,)),
        cp_vrnd_i=zeros("cp_vrnd_i", (n,)),
        cp_vval_src=torch.full((n,), -1, dtype=st["cp_vval_src"], device=dev),
        classic_epoch=zeros("classic_epoch", ()),
        round_idx=_i32(0, dev),
        retired=zeros("retired", (n,)),
    )


# ---------------------------------------------------------------------------
# Wide <-> compact converters
# ---------------------------------------------------------------------------


def _cast_lanes(tree, dtypes: Dict[str, str], fire_never_src: int, fire_never_out: int):
    """Every lane of an EngineState or FaultInputs tree (one cluster's or a
    fleet's) cast by VALUE to ``dtypes`` (the JAX package's ``astype``,
    wrapping), the fire-round sentinel mapped from ``fire_never_src`` to
    ``fire_never_out``. An unsigned lane is read by its own width
    (:func:`rapid_tpu_torch._narrow.unsigned`), a signed one by sign."""
    out = {}
    for field, value in tree._asdict().items():
        kind = LANE_SPECS[field][1]
        dt = _narrow.STORAGE[dtypes[field]]
        wide = _narrow.unsigned(value) if kind in UNSIGNED_KINDS else value.to(torch.int64)
        cast = _narrow.keep_bits(wide, dt)
        if field == "fire_round":
            cast = torch.where(value == fire_never_src, _narrow.keep_bits(
                torch.tensor(fire_never_out, device=value.device), dt), cast)
        out[field] = cast
    return type(tree)(**out)


def widen_state(cfg: EngineConfig, state):
    """A compact state (or fault masks) as the wide layout, the sentinel
    mapped to :data:`FIRE_NEVER`; the identity on a wide one. So a compact
    run is compared with a wide one as ``widen_state(compact_cfg, state)``
    against the wide state, lane by lane."""
    return _cast_lanes(
        state, lane_dtypes(cfg._replace(compact=0)), compaction_policy(cfg).fire_never, FIRE_NEVER
    )


def narrow_state(cfg: EngineConfig, state):
    """A WIDE state (or fault masks) at ``cfg``'s policy dtypes, the inverse
    of :func:`widen_state` within the envelopes. The casts wrap, as device
    casts do: check a state with :func:`validate_envelope` first."""
    return _cast_lanes(state, lane_dtypes(cfg), FIRE_NEVER, compaction_policy(cfg).fire_never)


def validate_envelope(cfg: EngineConfig, state: EngineState) -> None:
    """Host-side (reading) check that a WIDE state fits ``cfg``'s compact
    policy: counters within int16, ``round_idx`` within
    :data:`ROUND_ENVELOPE`, fire rounds real or the sentinel. Raises
    ValueError naming the first lane out of range."""
    if compaction_policy(cfg) == WIDE_POLICY:
        return
    limits = {
        "fd_count": (-(1 << 15), (1 << 15) - 1),
        "cp_rnd_r": (0, (1 << 15) - 1),
        "cp_vrnd_r": (0, (1 << 15) - 1),
        "classic_epoch": (0, (1 << 15) - 1),
        "rounds_undecided": (0, (1 << 15) - 1),
        "round_idx": (0, ROUND_ENVELOPE),
    }
    for field, (lo, hi) in limits.items():
        lane = getattr(state, field)
        if lane.numel():
            low, high = int(lane.min()), int(lane.max())
            if low < lo or high > hi:
                raise ValueError(
                    f"state lane {field!r} range [{low}, {high}] "
                    f"exceeds the compact envelope [{lo}, {hi}]"
                )
    real = state.fire_round[state.fire_round != FIRE_NEVER]
    if real.numel():
        low, high = int(real.min()), int(real.max())
        if low < 0 or high > ROUND_ENVELOPE:
            raise ValueError(
                f"fire_round carries a non-sentinel value outside "
                f"[0, {ROUND_ENVELOPE}]: [{low}, {high}]"
            )


# ---------------------------------------------------------------------------
# Bit-packed bool masks
# ---------------------------------------------------------------------------

#: bool lane -> the slot axis it packs 8 to a byte along.
PACKED_MASK_AXES: Dict[str, int] = {
    "alive": 0, "join_pending": 0, "vote_valid": 0, "retired": 0,
    "fd_fired": 0, "released": 1, "prop_mask": 1,
    "crashed": 0, "probe_fail": 0, "rx_block": 1,
}


def pack_bool(mask: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """A bool tensor packed 8 to a uint8 byte along ``axis``, little-endian
    in the byte (element i is bit i % 8 of byte i // 8). The axis length
    must be a multiple of 8."""
    mask = mask.to(torch.bool)
    size = mask.shape[axis]
    if size % 8:
        raise ValueError(f"pack_bool axis {axis} has length {size}, not a multiple of 8")
    moved = torch.movedim(mask, axis, -1)
    grouped = moved.reshape(*moved.shape[:-1], size // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    words = (grouped * weights).sum(-1, dtype=torch.int32).to(torch.uint8)
    return torch.movedim(words, -1, axis)


def unpack_bool(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bool`: uint8 bytes -> the bool mask, 8 times
    as long along ``axis``."""
    moved = torch.movedim(words.to(torch.uint8), axis, -1)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (moved[..., None] >> shifts) & 1
    flat = bits.reshape(*moved.shape[:-1], moved.shape[-1] * 8)
    return torch.movedim(flat, -1, axis).to(torch.bool)


def pack_masks(tree):
    """An EngineState or FaultInputs tree with every lane of
    :data:`PACKED_MASK_AXES` packed along its slot axis (``[n]`` ->
    ``[n/8]``, ``[c, n]`` -> ``[c, n/8]``, ``[n, k]`` -> ``[n/8, k]``).
    Needs ``n % 8 == 0``."""
    return type(tree)(**{
        field: pack_bool(value, PACKED_MASK_AXES[field]) if field in PACKED_MASK_AXES else value
        for field, value in tree._asdict().items()
    })


def unpack_masks(tree):
    """Inverse of :func:`pack_masks`."""
    return type(tree)(**{
        field: unpack_bool(value, PACKED_MASK_AXES[field]) if field in PACKED_MASK_AXES else value
        for field, value in tree._asdict().items()
    })


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------


def state_bytes_total(cfg: EngineConfig, packed: bool = False) -> int:
    """At-rest bytes of one cluster's EngineState and FaultInputs under
    ``cfg``'s policy; ``packed`` prices the bit-packed bool masks. Equal to
    :func:`pytree_nbytes` of a real state and fault tree."""
    dims = lane_dims(cfg)
    dtypes = lane_dtypes(cfg)
    total = 0
    for field, (shape, _) in LANE_SPECS.items():
        elems = math.prod(dims[s] for s in shape)
        if packed and field in PACKED_MASK_AXES:
            total += (elems + 7) // 8
        else:
            total += elems * np.dtype(dtypes[field]).itemsize
    return total


def state_bytes_per_member(cfg: EngineConfig, packed: bool = False) -> float:
    """Per-slot state bytes (:func:`state_bytes_total` over n)."""
    return state_bytes_total(cfg, packed=packed) / cfg.n


def pytree_nbytes(tree) -> int:
    """Bytes of the tensors of a lane tree (a NamedTuple of tensors; None
    for a plane that is off)."""
    if tree is None:
        return 0
    return sum(lane.numel() * lane.element_size() for lane in tree)

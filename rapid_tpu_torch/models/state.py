"""Engine state: N virtual membership endpoints as struct-of-arrays (port of
``rapid_tpu/models/state.py``, wide layout only).

Every lane has the JAX package's shape and wide dtype, with uint32 lanes
stored as int32 bit patterns (:mod:`rapid_tpu_torch._u32`). Scalars are 0-d
tensors on the state's device, so a round never reads them back unless it
branches on them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from rapid_tpu_torch.ops.hashing import masked_set_hash
from rapid_tpu_torch.ops.rings import ring_perms, ring_topology_from_perm

#: Sentinel fire round of an edge whose alert has not fired.
FIRE_NEVER = 1 << 30


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
    # State compaction (not ported yet: must be 0).
    compact: int = 0
    # Device telemetry plane (not ported yet: must be 0).
    telemetry: int = 0
    # Device round-trace ring capacity (not ported yet: must be 0).
    trace: int = 0


#: field -> (shape symbols over (n, k, c), stored kind). Kinds: "u32" lanes
#: are int32 bit patterns of uint32 values, "i32" int32, "bool" bool. The
#: JAX package's wide layout (its ``LANE_SPECS`` under ``WIDE_POLICY``).
LANES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    # EngineState
    "key_hi": (("k", "n"), "u32"),
    "key_lo": (("k", "n"), "u32"),
    "ring_perm": (("k", "n"), "i32"),
    "id_hi": (("n",), "u32"),
    "id_lo": (("n",), "u32"),
    "alive": (("n",), "bool"),
    "obs_idx": (("k", "n"), "i32"),
    "subj_idx": (("k", "n"), "i32"),
    "inval_obs": (("k", "n"), "i32"),
    "config_epoch": ((), "i32"),
    "config_hi": ((), "u32"),
    "config_lo": ((), "u32"),
    "n_members": ((), "i32"),
    "fd_count": (("n", "k"), "i32"),
    "fd_hist": (("n", "k"), "u32"),
    "fd_fired": (("n", "k"), "bool"),
    "fire_round": (("n", "k"), "i32"),
    "join_pending": (("n",), "bool"),
    "cohort_of": (("n",), "i32"),
    "report_bits": (("c", "n"), "u32"),
    "seen_down": (("c",), "bool"),
    "released": (("c", "n"), "bool"),
    "announced": (("c",), "bool"),
    "prop_mask": (("c", "n"), "bool"),
    "prop_hi": (("c",), "u32"),
    "prop_lo": (("c",), "u32"),
    "vote_hi": (("n",), "u32"),
    "vote_lo": (("n",), "u32"),
    "vote_valid": (("n",), "bool"),
    "rounds_undecided": ((), "i32"),
    "cp_rnd_r": (("n",), "i32"),
    "cp_rnd_i": (("n",), "i32"),
    "cp_vrnd_r": (("n",), "i32"),
    "cp_vrnd_i": (("n",), "i32"),
    "cp_vval_src": (("n",), "i32"),
    "classic_epoch": ((), "i32"),
    "round_idx": ((), "i32"),
    "retired": (("n",), "bool"),
    # FaultInputs
    "crashed": (("n",), "bool"),
    "probe_fail": (("n", "k"), "bool"),
    "rx_block": (("c", "n"), "bool"),
    # StepEvents (the lanes it does not share with EngineState)
    "decided": ((), "bool"),
    "fast_decided": ((), "bool"),
    "winner_mask": (("n",), "bool"),
    "proposals_announced": (("c",), "bool"),
    "alerts_emitted": ((), "i32"),
    "total_votes": ((), "i32"),
    "max_votes": ((), "i32"),
}

DTYPES = {"u32": torch.int32, "i32": torch.int32, "bool": torch.bool}


class EngineState(NamedTuple):
    """Device state for one virtual cluster (all lanes padded to n slots;
    see :data:`LANES` for shapes and kinds)."""

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


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but no card is available (pass device='cpu')")
    return dev


def validate_config(cfg: EngineConfig) -> None:
    """The JAX package's config checks, plus the options not ported yet."""
    if cfg.compact:
        raise NotImplementedError(
            "compact=1 is not ported yet (ROADMAP.md Queue 1 item 10, compaction)"
        )
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry=1 is not ported yet (ROADMAP.md Queue 1 item 9, telemetry plane)"
        )
    if cfg.trace:
        raise NotImplementedError(
            "trace>0 is not ported yet (ROADMAP.md Queue 1 item 9, round-trace ring)"
        )
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
    tensors) and the alive mask, all on one device."""
    validate_config(cfg)
    dev = alive.device
    n, k, c = cfg.n, cfg.k, cfg.c
    perm = ring_perms(key_hi, key_lo)
    topo = ring_topology_from_perm(perm, alive)
    config_hi, config_lo = masked_set_hash(id_hi, id_lo, alive)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EngineState(
        key_hi=key_hi,
        key_lo=key_lo,
        ring_perm=perm,
        id_hi=id_hi,
        id_lo=id_lo,
        alive=alive,
        obs_idx=topo.obs_idx,
        subj_idx=topo.subj_idx,
        inval_obs=topo.obs_idx.clone(),
        config_epoch=_i32(0, dev),
        config_hi=config_hi,
        config_lo=config_lo,
        n_members=alive.sum(dtype=torch.int32),
        fd_count=zeros((n, k)),
        fd_hist=zeros((n, k)),
        fd_fired=zeros((n, k), torch.bool),
        fire_round=torch.full((n, k), FIRE_NEVER, dtype=torch.int32, device=dev),
        join_pending=zeros((n,), torch.bool),
        cohort_of=zeros((n,)),
        report_bits=zeros((c, n)),
        seen_down=zeros((c,), torch.bool),
        released=zeros((c, n), torch.bool),
        announced=zeros((c,), torch.bool),
        prop_mask=zeros((c, n), torch.bool),
        prop_hi=zeros((c,)),
        prop_lo=zeros((c,)),
        vote_hi=zeros((n,)),
        vote_lo=zeros((n,)),
        vote_valid=zeros((n,), torch.bool),
        rounds_undecided=_i32(0, dev),
        cp_rnd_r=zeros((n,)),
        cp_rnd_i=zeros((n,)),
        cp_vrnd_r=zeros((n,)),
        cp_vrnd_i=zeros((n,)),
        cp_vval_src=torch.full((n,), -1, dtype=torch.int32, device=dev),
        classic_epoch=_i32(0, dev),
        round_idx=_i32(0, dev),
        retired=zeros((n,), torch.bool),
    )

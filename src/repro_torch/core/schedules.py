"""Client-availability schedules and arrival/latency processes, in numpy
only, so every mask, wake time and latency equals the reference's bit for
bit.

A ``Schedule`` answers two questions per round:

  available(rnd, n) -> (n,) bool   who trains & uploads THIS round
  joined(rnd, n)    -> (n,) bool   who is a member by now (monotone; used
                                   for eval averaging)

Clients outside ``available`` keep their stale repository row and their
params and optimizer state are frozen for the round. Schedules are
deterministic functions of (seed, round).

An ``ArrivalProcess`` is what the event runtime (``repro_torch.core.
runtime``) consumes: (virtual_time, mask) local-round completions plus a
per-client upload latency, so stragglers lag in *time* rather than being
masked out, arrivals can cluster into bursts, and devices can tick at
heterogeneous cadences. Any mask ``Schedule`` adapts via the
``ScheduleArrivals`` shim.

Both families are registries: ``@register_schedule`` /
``@register_arrivals`` make a new pattern reachable by name.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

_REGISTRY: Dict[str, Type["Schedule"]] = {}


def register_schedule(name: str):
    def deco(cls: Type["Schedule"]) -> Type["Schedule"]:
        if name in _REGISTRY:
            raise ValueError(f"schedule {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def registered_schedules() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_schedule(name: str) -> Type["Schedule"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown schedule {name!r}; registered: "
                       f"{registered_schedules()}") from None


class Schedule(abc.ABC):
    name: str = "?"

    @abc.abstractmethod
    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        """(n,) bool — clients that participate in round ``rnd``."""

    def joined(self, rnd: int, n_clients: int) -> np.ndarray:
        """(n,) bool — federation members as of round ``rnd``. Default:
        same as availability (correct for monotone schedules)."""
        return self.available(rnd, n_clients)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


@register_schedule("always-on")
class AlwaysOn(Schedule):
    """Every client participates every round (the synchronous baseline)."""

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        return np.ones(n_clients, bool)


@register_schedule("staged-join")
class StagedJoin(Schedule):
    """Client n joins at ``join_round[n]`` and stays — the paper's §IV-F
    asynchronous staged-facility scenario."""

    def __init__(self, join_round: Sequence[int]):
        self.join_round = np.asarray(join_round)

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        if self.join_round.shape[0] != n_clients:
            raise ValueError(f"join_round has {self.join_round.shape[0]} "
                             f"entries for {n_clients} clients")
        return self.join_round <= rnd

    def __repr__(self) -> str:
        return f"StagedJoin(stages={sorted(set(self.join_round.tolist()))})"


@register_schedule("dropout")
class RandomDropout(Schedule):
    """IoT reality: each joined client independently misses a round with
    probability ``p`` (device offline / battery / connectivity). Composable
    over a base schedule, e.g. ``RandomDropout(0.3, base=StagedJoin(...))``.

    At least one joined client is always kept so every round makes
    progress."""

    def __init__(self, p: float = 0.2, seed: int = 0,
                 base: Optional[Schedule] = None):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p
        self.seed = seed
        self.base = base or AlwaysOn()

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        joined = self.base.available(rnd, n_clients)
        rng = np.random.default_rng((self.seed, rnd))
        up = rng.random(n_clients) >= self.p
        if joined.any() and not (up & joined).any():
            up[int(np.argmax(joined))] = True
        return up & joined

    def joined(self, rnd: int, n_clients: int) -> np.ndarray:
        return self.base.joined(rnd, n_clients)

    def __repr__(self) -> str:
        return f"RandomDropout(p={self.p}, base={self.base!r})"


@register_schedule("straggler")
class Straggler(Schedule):
    """A fixed random ``fraction`` of clients is slow hardware: stragglers
    only complete a round every ``period`` rounds (uploading fresh
    messengers then; stale in between)."""

    def __init__(self, fraction: float = 0.3, period: int = 3, seed: int = 0,
                 base: Optional[Schedule] = None):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.fraction = fraction
        self.period = period
        self.seed = seed
        self.base = base or AlwaysOn()

    def slow_mask(self, n_clients: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        k = int(round(self.fraction * n_clients))
        slow = np.zeros(n_clients, bool)
        slow[rng.choice(n_clients, size=k, replace=False)] = True
        return slow

    def available(self, rnd: int, n_clients: int) -> np.ndarray:
        ok = ~self.slow_mask(n_clients) | (rnd % self.period == 0)
        return ok & self.base.available(rnd, n_clients)

    def joined(self, rnd: int, n_clients: int) -> np.ndarray:
        return self.base.joined(rnd, n_clients)

    def __repr__(self) -> str:
        return (f"Straggler(fraction={self.fraction}, "
                f"period={self.period}, base={self.base!r})")


def as_schedule(schedule: Union[None, str, Schedule],
                join_round=None) -> Schedule:
    """Coerce None/name/instance into a Schedule; ``join_round`` (legacy
    array argument) wins when no explicit schedule is given."""
    if isinstance(schedule, Schedule):
        return schedule
    if isinstance(schedule, str):
        return get_schedule(schedule)()
    if join_round is not None:
        return StagedJoin(join_round)
    return AlwaysOn()


# --------------------------------------------------------------------------
# Arrival/latency processes — the event-runtime generalization of masks.
# --------------------------------------------------------------------------

_ARRIVALS: Dict[str, Type["ArrivalProcess"]] = {}

Wake = Tuple[float, np.ndarray]


def register_arrivals(name: str):
    def deco(cls: Type["ArrivalProcess"]) -> Type["ArrivalProcess"]:
        if name in _ARRIVALS:
            raise ValueError(f"arrival process {name!r} already registered")
        cls.name = name
        _ARRIVALS[name] = cls
        return cls

    return deco


def registered_arrivals() -> Tuple[str, ...]:
    return tuple(sorted(_ARRIVALS))


def get_arrivals(name: str) -> Type["ArrivalProcess"]:
    try:
        return _ARRIVALS[name]
    except KeyError:
        raise KeyError(f"unknown arrival process {name!r}; registered: "
                       f"{registered_arrivals()}") from None


class ArrivalProcess(abc.ABC):
    """When clients complete local work, and how late their uploads land.

    ``wakes(n, until)`` returns the sorted deterministic list of
    (virtual_time, (n,) bool mask) local-round completions in
    ``[0, until]``; ``latency(t, mask, n)`` the per-client upload delay for
    the wake at ``t`` (a messenger produced at ``t`` reaches the server at
    ``t + latency``, merging *stale* relative to anything fresher — it is
    merged on arrival, never dropped). Pure functions of (seed, args), so
    event runs are reproducible and resumable."""

    name: str = "?"

    @abc.abstractmethod
    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        """Sorted (time, mask) local-round completions in [0, until]."""

    def latency(self, t: float, mask: np.ndarray,
                n_clients: int) -> np.ndarray:
        """(n,) float upload delay for clients waking at ``t`` (default 0:
        uploads arrive the instant local work finishes)."""
        return np.zeros(n_clients)

    def joined(self, t: float, n_clients: int) -> Optional[np.ndarray]:
        """(n,) bool membership mask at time ``t`` for eval averaging, or
        None to fall back on 'every client that has ever woken'."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


@register_arrivals("schedule")
class ScheduleArrivals(ArrivalProcess):
    """Shim: any per-round mask ``Schedule`` as a unit-cadence,
    zero-latency arrival process — StagedJoin / RandomDropout / Straggler /
    AlwaysOn all run under the event engine unchanged."""

    def __init__(self, schedule: Union[None, str, Schedule] = None,
                 cadence: float = 1.0):
        if cadence <= 0:
            raise ValueError(f"cadence must be > 0, got {cadence}")
        self.schedule = as_schedule(schedule)
        self.cadence = float(cadence)

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        out: List[Wake] = []
        r = 0
        while r * self.cadence <= until + 1e-9:
            # all-False rounds are emitted too: the sync engine burns RNG
            # splits and fires an (empty) communication round on them, and
            # shim equivalence must reproduce that exactly
            mask = np.asarray(self.schedule.available(r, n_clients), bool)
            out.append((r * self.cadence, mask))
            r += 1
        return out

    def joined(self, t: float, n_clients: int) -> Optional[np.ndarray]:
        return np.asarray(
            self.schedule.joined(int(round(t / self.cadence)), n_clients),
            bool)

    def __repr__(self) -> str:
        return f"ScheduleArrivals({self.schedule!r}, cadence={self.cadence})"


@register_arrivals("straggler-latency")
class StragglerLatency(ArrivalProcess):
    """Real lag, not masking: every client completes local work each tick,
    but a fixed slow ``fraction`` uploads with ``delay`` — their messengers
    arrive stale and merge into the repository on arrival."""

    def __init__(self, fraction: float = 0.3, delay: float = 2.0,
                 seed: int = 0, cadence: float = 1.0):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        if delay < 0:
            raise ValueError(f"delay must be >= 0, got {delay}")
        if cadence <= 0:
            raise ValueError(f"cadence must be > 0, got {cadence}")
        self.fraction = fraction
        self.delay = float(delay)
        self.seed = seed
        self.cadence = float(cadence)

    def slow_mask(self, n_clients: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        k = int(round(self.fraction * n_clients))
        slow = np.zeros(n_clients, bool)
        slow[rng.choice(n_clients, size=k, replace=False)] = True
        return slow

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        out: List[Wake] = []
        r = 0
        while r * self.cadence <= until + 1e-9:
            out.append((r * self.cadence, np.ones(n_clients, bool)))
            r += 1
        return out

    def latency(self, t: float, mask: np.ndarray,
                n_clients: int) -> np.ndarray:
        return np.where(self.slow_mask(n_clients), self.delay, 0.0)

    def __repr__(self) -> str:
        return (f"StragglerLatency(fraction={self.fraction}, "
                f"delay={self.delay})")


@register_arrivals("cadence")
class HeterogeneousCadence(ArrivalProcess):
    """Device-speed heterogeneity: client ``c`` completes a local round
    every ``period_c ~ U[fast, slow]`` virtual seconds, so fast devices
    simply tick more often — no client is ever masked out."""

    def __init__(self, fast: float = 1.0, slow: float = 3.0, seed: int = 0):
        if not 0 < fast <= slow:
            raise ValueError(f"need 0 < fast <= slow, got {fast}, {slow}")
        self.fast = float(fast)
        self.slow = float(slow)
        self.seed = seed

    def periods(self, n_clients: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return np.round(rng.uniform(self.fast, self.slow, n_clients), 6)

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        per = self.periods(n_clients)
        by_t: Dict[float, np.ndarray] = {}
        for c in range(n_clients):
            k = 0
            while k * per[c] <= until + 1e-9:
                t = round(k * per[c], 6)
                by_t.setdefault(t, np.zeros(n_clients, bool))[c] = True
                k += 1
        return [(t, by_t[t]) for t in sorted(by_t)]

    def __repr__(self) -> str:
        return f"HeterogeneousCadence(fast={self.fast}, slow={self.slow})"


@register_arrivals("bursty")
class BurstyArrivals(ArrivalProcess):
    """Arrivals cluster: every ``burst_every`` seconds a random ``frac``
    subset completes together, and per-client jitter in ``[0, jitter]``
    spreads their uploads inside the burst window."""

    def __init__(self, burst_every: float = 4.0, frac: float = 0.6,
                 jitter: float = 0.5, seed: int = 0):
        if burst_every <= 0:
            raise ValueError(f"burst_every must be > 0, got {burst_every}")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.burst_every = float(burst_every)
        self.frac = frac
        self.jitter = float(jitter)
        self.seed = seed

    def wakes(self, n_clients: int, until: float) -> List[Wake]:
        out: List[Wake] = []
        b = 0
        while b * self.burst_every <= until + 1e-9:
            rng = np.random.default_rng((self.seed, 7, b))
            mask = rng.random(n_clients) < self.frac
            if not mask.any():
                mask[int(rng.integers(n_clients))] = True
            out.append((b * self.burst_every, mask))
            b += 1
        return out

    def latency(self, t: float, mask: np.ndarray,
                n_clients: int) -> np.ndarray:
        b = int(round(t / self.burst_every))
        rng = np.random.default_rng((self.seed, 11, b))
        return np.round(rng.random(n_clients) * self.jitter, 6)

    def __repr__(self) -> str:
        return (f"BurstyArrivals(burst_every={self.burst_every}, "
                f"frac={self.frac}, jitter={self.jitter})")


def as_arrivals(arrivals: Union[None, str, Schedule, ArrivalProcess]
                ) -> ArrivalProcess:
    """Coerce None / name / Schedule / instance into an ArrivalProcess.
    A mask Schedule (instance or registered name) adapts via the
    ``ScheduleArrivals`` shim; None means always-on unit cadence."""
    if isinstance(arrivals, ArrivalProcess):
        return arrivals
    if isinstance(arrivals, Schedule):
        return ScheduleArrivals(arrivals)
    if isinstance(arrivals, str):
        try:
            return get_arrivals(arrivals)()
        except KeyError:
            return ScheduleArrivals(get_schedule(arrivals)())
    return ScheduleArrivals(AlwaysOn())

"""Lightweight metrics registry for the serving engine.

Three metric kinds, all plain host-side Python (no device work, no
locks — the engine is single-threaded per tick):

- `Counter` — a monotonic count (``inc``); `set` exists for the
  dict-view compat surface below.
- `Gauge`   — a point-in-time level (``set``): page-pool occupancy,
  queue depth.
- `Histogram` — bucketed distribution over fixed edges.  Bucket ``i``
  counts observations in ``(edges[i-1], edges[i]]`` (values exactly on
  an edge land in the bucket the edge closes — Prometheus ``le``
  semantics); one overflow bucket catches everything past the last
  edge.  Percentiles are estimated as the upper bound of the bucket
  holding the rank, clamped to the observed min/max.

`MetricsRegistry` is the namespace: dotted canonical names
(``engine.ttft_s``, ``sched.submitted``, ``kv.pages_in_use``, ...),
``snapshot()`` for machine-readable export, ``render()`` for the
human-readable on-exit dump.  `MetricView` is a live dict-shaped view
over one name prefix — the compat surface that lets pre-registry call
sites (``stats["cow_copies"] += 1``) and their tests keep working while
the values actually live in the registry.

``diff_snapshots`` subtracts one snapshot from another (counters and
histogram count/sum pairwise) so benchmarks can report workload-only
deltas without hand-rolled per-key lists.
"""
from __future__ import annotations

import json
import math
from bisect import bisect_left
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

# default histogram edges: latencies in seconds, ~log-spaced 10us..60s
DEFAULT_TIME_EDGES: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    __slots__ = ("name", "edges", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_TIME_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"edges must be strictly ascending: {edges}")
        self.name = name
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)    # last = overflow (+Inf)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]): the upper edge of
        the bucket containing the rank, clamped to observed min/max."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                return float(min(max(hi, self.vmin), self.vmax))
        return float(self.vmax)                  # pragma: no cover

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "count": self.count,
            "sum": round(self.total, 9),
            "mean": round(self.mean, 9),
        }
        if self.count:
            out.update(min=round(self.vmin, 9), max=round(self.vmax, 9),
                       p50=round(self.percentile(50), 9),
                       p99=round(self.percentile(99), 9))
        # cumulative le-counts, only edges that separate observations
        # (keeps exported JSON small while staying reconstructible)
        cum, acc = [], 0
        for i, c in enumerate(self.counts):
            acc += c
            le = self.edges[i] if i < len(self.edges) else "+Inf"
            if c:
                cum.append([le, acc])
        out["buckets"] = cum
        return out


class MetricView(MutableMapping):
    """Live dict-shaped view over a registry's counters under one
    prefix.  Reads return the counter's current value; writes set it —
    so legacy ``stats["x"] += 1`` call sites publish straight into the
    registry.  Unknown keys are registered on first touch."""

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 keys: Sequence[str] = ()):
        self._r = registry
        self._p = prefix
        self._keys: List[str] = []
        for k in keys:
            self._touch(k)

    def _full(self, k: str) -> str:
        return f"{self._p}.{k}" if self._p else k

    def _touch(self, k: str) -> Counter:
        c = self._r.counter(self._full(k))
        if k not in self._keys:
            self._keys.append(k)
        return c

    def __getitem__(self, k: str) -> Number:
        return self._touch(k).value

    def __setitem__(self, k: str, v: Number) -> None:
        self._touch(k).set(v)

    def __delitem__(self, k: str) -> None:
        raise TypeError("metrics cannot be deleted")

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._keys))

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return f"MetricView({dict(self)!r})"


class MetricsRegistry:
    """Get-or-create namespace of metrics, keyed by dotted name."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        if name in self._metrics:
            return self._get(name, Histogram)
        return self._get(name, Histogram, edges or DEFAULT_TIME_EDGES)

    def group(self, prefix: str, keys: Sequence[str] = ()) -> MetricView:
        return MetricView(self, prefix, keys)

    def scoped(self, prefix: str) -> "ScopedRegistry":
        """A registry view that prepends ``<prefix>.`` to every metric
        name — the per-model label mechanism for the multi-model engine
        (each hosted model's ``engine.*`` / ``kv.*`` metrics publish as
        ``model.<name>.engine.*`` in the ONE shared parent registry)."""
        return ScopedRegistry(self, prefix)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Flat {canonical name: value-or-histogram-summary} dict."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.snapshot() if isinstance(m, Histogram) \
                else m.value
        return out

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"metrics": self.snapshot()}, f, indent=1)

    def render(self) -> str:
        """Human-readable snapshot (the on-exit dump)."""
        lines = []
        width = max((len(n) for n in self._metrics), default=0)
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                if m.count:
                    body = (f"count={m.count} mean={m.mean:.6f} "
                            f"p50={m.percentile(50):.6f} "
                            f"p99={m.percentile(99):.6f} "
                            f"max={m.vmax:.6f}")
                else:
                    body = "count=0"
                kind = "hist"
            else:
                kind = "gauge" if isinstance(m, Gauge) else "counter"
                v = m.value
                body = f"{v:.6f}".rstrip("0").rstrip(".") \
                    if isinstance(v, float) else str(v)
            lines.append(f"{kind:7s} {name:<{width}}  {body}")
        return "\n".join(lines)


class ScopedRegistry:
    """A prefix-scoped view over a parent `MetricsRegistry`.

    Every metric created through it lives in the PARENT under
    ``<prefix>.<name>`` — one flat namespace holds every hosted
    model's metrics side by side (``model.a.engine.tokens`` next to
    ``model.b.engine.tokens``), so one ``snapshot()``/``export()`` on
    the parent captures the whole multi-model engine.  The view's own
    ``snapshot()``/``render()`` are filtered to the scope, keeping
    per-engine readers (``Engine.stats()``, bench workload deltas)
    working unchanged on a scoped engine."""

    def __init__(self, parent: "MetricsRegistry", prefix: str):
        if not prefix or prefix.endswith("."):
            raise ValueError(f"bad scope prefix: {prefix!r}")
        # collapse nested scopes so there is exactly one parent level
        if isinstance(parent, ScopedRegistry):
            prefix = f"{parent.prefix}.{prefix}"
            parent = parent.parent
        self.parent = parent
        self.prefix = prefix

    def _full(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def counter(self, name: str) -> Counter:
        return self.parent.counter(self._full(name))

    def gauge(self, name: str) -> Gauge:
        return self.parent.gauge(self._full(name))

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        return self.parent.histogram(self._full(name), edges)

    def group(self, prefix: str, keys: Sequence[str] = ()) -> MetricView:
        return self.parent.group(self._full(prefix), keys)

    def scoped(self, prefix: str) -> "ScopedRegistry":
        return ScopedRegistry(self, prefix)

    def snapshot(self) -> Dict[str, object]:
        """The parent snapshot filtered to this scope (full names kept,
        so scoped and parent snapshots diff against each other)."""
        pre = self.prefix + "."
        return {k: v for k, v in self.parent.snapshot().items()
                if k.startswith(pre)}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"metrics": self.snapshot()}, f, indent=1)

    def render(self) -> str:
        pre = self.prefix + "."
        lines = self.parent.render().splitlines()
        return "\n".join(ln for ln in lines if pre in ln)


def diff_snapshots(new: Dict[str, object],
                   base: Dict[str, object]) -> Dict[str, object]:
    """Workload-only delta of two ``MetricsRegistry.snapshot()`` dicts:
    numbers subtract, histogram summaries subtract count/sum (mean is
    recomputed; order statistics are not diffable and are dropped).
    Names absent from ``base`` pass through unchanged."""
    out: Dict[str, object] = {}
    for name, v in new.items():
        b = base.get(name)
        if isinstance(v, dict):                  # histogram summary
            bc = b if isinstance(b, dict) else {}
            dc = v["count"] - bc.get("count", 0)
            ds = round(v["sum"] - bc.get("sum", 0.0), 9)
            out[name] = {"count": dc, "sum": ds,
                         "mean": round(ds / dc, 9) if dc else 0.0}
        elif isinstance(v, (int, float)) and isinstance(b, (int, float)):
            out[name] = round(v - b, 9) if isinstance(v, float) else v - b
        else:
            out[name] = v
    return out

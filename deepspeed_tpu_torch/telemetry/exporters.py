"""Pluggable exporters: serialize MetricsRegistry views to scalar sinks.

Port of deepspeed_tpu/telemetry/exporters.py. ``JsonlExporter`` writes
through ``utils.monitor.JsonlSummaryWriter`` (one RFC-compliant JSON
object per line) and ``SummaryWriterExporter`` through
``utils.monitor.get_summary_writer`` (PyTorch's TensorBoard writer when
the ``tensorboard`` package is installed, the JSONL writer otherwise).
``PrometheusTextfileExporter`` rewrites a textfile atomically on every
export, the contract of the node-exporter textfile collector that pod
scrapers mount; :func:`render_prometheus` gives the same bytes as the JAX
package's for the same entries.
"""

import math
import os
import re
import time

from ..utils.logging import logger, warn_once
from .registry import count_suppressed, metric_to_wire


class MetricExporter:
    """One exporter = one sink. ``export`` receives the registry's
    ``collect()`` list plus the step index the values settle at."""

    def export(self, metrics, step):
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass


class JsonlExporter(MetricExporter):
    """Registry -> ``metrics.jsonl``: counters/gauges as the writer's
    standard ``{tag, value, step, wall_time}`` records, histograms as one
    ``kind: "histogram"`` record carrying thresholds and counts."""

    def __init__(self, log_dir, filename="metrics.jsonl"):
        from ..utils.monitor import JsonlSummaryWriter

        self.writer = JsonlSummaryWriter(log_dir, filename=filename)

    def export(self, metrics, step):
        now = time.time()
        for m in metrics:
            if m.kind == "histogram":
                record = {
                    "tag": m.name,
                    "kind": "histogram",
                    "count": m.count,
                    "sum": m.sum,
                    "thresholds": list(m.thresholds),
                    "bucket_counts": list(m.bucket_counts),
                    "step": step,
                    "wall_time": now,
                }
                exemplars = getattr(m, "exemplars", None)
                if exemplars:
                    # bucket index -> [value, trace_id, unix ts]: the
                    # metric->trace link (docs/observability.md)
                    record["exemplars"] = {
                        str(i): list(e) for i, e in exemplars.items()
                    }
                self.writer.add_record(record)
            else:
                self.writer.add_scalar(m.name, m.value, global_step=step)
        self.writer.flush()

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class SummaryWriterExporter(MetricExporter):
    """Registry -> TensorBoard scalar streams (torch SummaryWriter when
    available, events.jsonl fallback). Histograms export as ``name/count``
    and ``name/sum`` scalars — the navigable trend of a histogram without
    requiring torch's histogram protos."""

    def __init__(self, log_dir=None, job_name="DeepSpeedJobName", writer=None):
        if writer is None:
            from ..utils.monitor import get_summary_writer

            writer = get_summary_writer(name=job_name, base=log_dir)
        self.writer = writer

    def export(self, metrics, step):
        for m in metrics:
            if m.kind == "histogram":
                self.writer.add_scalar(m.name + "/count", m.count, global_step=step)
                self.writer.add_scalar(m.name + "/sum", m.sum, global_step=step)
            else:
                self.writer.add_scalar(m.name, m.value, global_step=step)
        self.writer.flush()

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


def prometheus_name(name):
    """Sanitize a registry name into the Prometheus charset
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): ``train/loss`` -> ``train_loss``."""
    sanitized = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if re.match(r"^[0-9]", sanitized):
        sanitized = "_" + sanitized
    return sanitized


def _format_value(v):
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _exemplar_line(name, le, exemplar):
    """Exemplar as a standalone COMMENT line following its bucket
    sample (OpenMetrics-style payload, classic-format-safe carrier):
    the 0.0.4 text format the node-exporter textfile collector parses
    rejects trailing tokens on a sample line, so an inline OpenMetrics
    ``# {...}`` tail would invalidate the whole .prom file the moment
    tracing armed. A full-line ``#`` comment is ignored by every
    classic parser and still carries the trace link for humans and
    OpenMetrics-aware tooling. None when the bucket never saw a traced
    observation."""
    if not exemplar:
        return None
    value, trace_id, ts = exemplar
    return (
        f'# EXEMPLAR {name}_bucket{{le="{le}"}} '
        f'{{trace_id="{trace_id}"}} {_format_value(value)} {ts:.3f}'
    )


def _escape_label_value(v):
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(labels, extra=None):
    """``{node="n0",replica="r0",le="5.0"}`` (``extra`` is an already
    formatted trailing pair, how histogram buckets append ``le``);
    empty string when there is nothing to say — a bare sample name."""
    parts = [
        f'{k}="{_escape_label_value(v)}"' for k, v in (labels or {}).items()
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(entries):
    """Wire entries (:func:`..registry.metric_to_wire` dicts, optionally
    carrying a ``labels`` dict) -> Prometheus 0.0.4 text exposition.

    Shared by the textfile exporter (unlabeled, per-process) and the
    telemetry hub's ``GET /metrics`` (fleet view, ``{node, replica}``
    labels). Samples are grouped by prom name so HELP/TYPE emit exactly
    once per family even when many label sets share it — the format
    requires a family's samples to be contiguous.

    ``prometheus_name()`` is lossy (``a/b`` and ``a.b`` both sanitize to
    ``a_b``), so two DISTINCT registry names can collide on one prom
    name. Silently interleaving their samples would corrupt the series;
    instead the first registry name claims the prom name, later distinct
    names are dropped with a debug log + ``count_suppressed`` — visible
    in ``internal/suppressed_errors/telemetry.prom_name_collision``
    instead of invisible in a merged series. A kind mismatch inside one
    family (possible only across registries) is dropped the same way.
    """
    order = []
    groups = {}
    owner = {}  # prom name -> the registry name that claimed it
    for e in entries:
        name = e.get("name", "")
        prom = prometheus_name(name)
        claimed = owner.get(prom)
        if claimed is None:
            owner[prom] = name
        elif claimed != name:
            logger.debug(
                "prometheus name collision: %r and %r both map to %r; "
                "keeping the first", claimed, name, prom,
            )
            count_suppressed("telemetry.prom_name_collision")
            continue
        group = groups.get(prom)
        if group is None:
            groups[prom] = group = []
            order.append(prom)
        elif group[0].get("kind") != e.get("kind"):
            logger.debug(
                "prometheus kind mismatch for %r: %r vs %r; dropping the "
                "latter sample", prom, group[0].get("kind"), e.get("kind"),
            )
            count_suppressed("telemetry.prom_name_collision")
            continue
        group.append(e)
    lines = []
    for prom in order:
        group = groups[prom]
        help_text = next((e.get("help") for e in group if e.get("help")), "")
        if help_text:
            lines.append(f"# HELP {prom} {help_text}")
        lines.append(f"# TYPE {prom} {group[0].get('kind')}")
        for e in group:
            labels = e.get("labels")
            if e.get("kind") == "histogram":
                # exemplars (bucket index -> (value, trace_id, ts)):
                # the histogram->trace link, carried as comment lines
                # beside the bucket samples (see _exemplar_line for why
                # not an inline OpenMetrics tail)
                exemplars = e.get("exemplars") or {}
                cumulative = 0
                thresholds = e.get("thresholds", ())
                counts = e.get("bucket_counts", ())
                for i, (threshold, count) in enumerate(
                    zip(thresholds, counts)
                ):
                    cumulative += count
                    le = _format_value(threshold)
                    le_pair = 'le="' + le + '"'
                    lines.append(
                        f'{prom}_bucket{_label_str(labels, extra=le_pair)} '
                        f'{cumulative}'
                    )
                    ex = _exemplar_line(
                        prom, le, exemplars.get(i, exemplars.get(str(i)))
                    )
                    if ex:
                        lines.append(ex)
                total = int(e.get("count", 0))
                inf_pair = 'le="+Inf"'
                lines.append(
                    f'{prom}_bucket{_label_str(labels, extra=inf_pair)} '
                    f'{total}'
                )
                inf_idx = len(thresholds)
                ex = _exemplar_line(
                    prom, "+Inf",
                    exemplars.get(inf_idx, exemplars.get(str(inf_idx))),
                )
                if ex:
                    lines.append(ex)
                lines.append(
                    f'{prom}_sum{_label_str(labels)} '
                    f'{_format_value(e.get("sum", 0.0))}'
                )
                lines.append(f"{prom}_count{_label_str(labels)} {total}")
            else:
                lines.append(
                    f'{prom}{_label_str(labels)} '
                    f'{_format_value(e.get("value", 0.0))}'
                )
    return "\n".join(lines) + "\n"


class PrometheusTextfileExporter(MetricExporter):
    """Registry -> Prometheus text exposition format, rewritten atomically
    (write-temp-then-rename) so a scraper never reads a torn file. Point
    the node-exporter textfile collector (or any sidecar that serves
    ``*.prom`` files) at the directory."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def export(self, metrics, step):
        del step  # prometheus samples carry scrape time, not step indices
        text = render_prometheus(metric_to_wire(m) for m in metrics)
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)
        except OSError as e:
            warn_once(
                ("prom_unwritable", self.path),
                "prometheus textfile %s not writable (%s); further export "
                "failures are silent", self.path, e,
            )


def build_exporter(name, out_dir, job_name, prometheus_path=None):
    """Exporter factory for the config-named kinds."""
    if name == "jsonl":
        return JsonlExporter(out_dir)
    if name == "tensorboard":
        return SummaryWriterExporter(log_dir=os.path.dirname(out_dir) or ".",
                                     job_name=job_name)
    if name == "prometheus":
        return PrometheusTextfileExporter(
            prometheus_path or os.path.join(out_dir, "metrics.prom")
        )
    raise ValueError(f"unknown telemetry exporter {name!r}")

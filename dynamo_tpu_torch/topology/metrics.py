"""dyn_topology_* metric families (text exposition helper).

One renderer serves both scrape surfaces: the frontend appends these lines
to its ``/metrics`` body (next to the resilience counters), and the metrics
service mirrors the same families through its prometheus registry.  Every
family is always DECLARED (``# HELP``/``# TYPE``) even with no map attached,
so ``scripts/check_metrics.py`` can assert the surface unconditionally.
"""

from __future__ import annotations

HOP_CLASSES = ("local", "ici", "dcn")

_FAMILIES = (
    ("dyn_topology_nodes", "Workers with a published topology card"),
    ("dyn_topology_links", "Pairwise links in the fleet topology map by hop class"),
    ("dyn_topology_probe_rtt_seconds", "Probe round-trip EWMA by hop class"),
    ("dyn_topology_probe_bandwidth_bps",
     "Measured link bandwidth EWMA by hop class"),
    ("dyn_topology_map_age_seconds",
     "Seconds since the topology map last changed"),
)


def hop_summaries(topo_map) -> dict[str, dict[str, float]]:
    """Per-hop-class link count + mean measured RTT/bandwidth (means over
    the links of that class that actually carry a measurement)."""
    out = {
        hop: {"links": 0.0, "rtt_s": 0.0, "bps": 0.0, "_rtt_n": 0, "_bps_n": 0}
        for hop in HOP_CLASSES
    }
    if topo_map is None:
        return out
    for (a, b), link in getattr(topo_map, "_links", {}).items():
        row = out.get(link.hop)
        if row is None:
            continue
        row["links"] += 1
        if link.rtt_s > 0:
            row["rtt_s"] += link.rtt_s
            row["_rtt_n"] += 1
        if link.measured_bps > 0:
            row["bps"] += link.measured_bps
            row["_bps_n"] += 1
    for row in out.values():
        if row["_rtt_n"]:
            row["rtt_s"] /= row["_rtt_n"]
        if row["_bps_n"]:
            row["bps"] /= row["_bps_n"]
    return out


def render(topo_map=None) -> bytes:
    """Prometheus text lines for the topology families (frontend surface)."""
    lines: list[str] = []
    for name, help_text in _FAMILIES:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
        if name == "dyn_topology_nodes":
            n = len(topo_map.nodes) if topo_map is not None else 0
            lines.append(f"{name} {float(n)}")
        elif name == "dyn_topology_map_age_seconds":
            age = topo_map.age_s() if topo_map is not None else 0.0
            lines.append(f"{name} {age:.6f}")
        else:
            summaries = hop_summaries(topo_map)
            key = {
                "dyn_topology_links": "links",
                "dyn_topology_probe_rtt_seconds": "rtt_s",
                "dyn_topology_probe_bandwidth_bps": "bps",
            }[name]
            for hop in HOP_CLASSES:
                lines.append(
                    f'{name}{{hop="{hop}"}} {summaries[hop][key]:.6f}'
                )
    return ("\n".join(lines) + "\n").encode()

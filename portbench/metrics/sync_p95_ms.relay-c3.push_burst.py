"""The 95th percentile of a sync POST's latency at the device in the
push_burst cell, over every request of the window (a failed request
counts as missing). An end-to-end metric by nature, kept per-layer: its
spread between runs on the H100's host (up to a quarter of its median)
needs a wider bound than a benchmark may set."""


def read(obs):
    return obs.get("traffic", {}).get("p95_ms")

"""Requests a device batch of the server in the window, from its stats() counters."""


def read(r):
    a, b = r.get("stats_before"), r.get("stats_after")
    if not a or not b or b["batches"] == a["batches"]:
        return None
    return (b["requests"] - a["requests"]) / (b["batches"] - a["batches"])

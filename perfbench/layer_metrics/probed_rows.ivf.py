"""Live rows in the union of clusters a search batch probes: what route +
K5 read a batch, and what a smaller nprobe or a pruning margin would cut,
recall with it. The mean over the window's own batches in its first
third, as the program routed them (`route_union`, counted on the device
and read after the window)."""


def read(obs):
    rows = obs.get("probed_rows")
    return sum(rows) / len(rows) if rows else None

"""One module a traffic kind; a traffic file's `kind` names it. Each has
`run(ctx) -> dict` (see perfbench/run.py for the keys)."""

"""Median milliseconds of the searches due in the window's first third,
each from its scheduled send to its full response (one never answered
counts as the longest): the span whose counters the other HTTP readers
take, before the traced run's profiler slows the server."""


def read(obs):
    return obs.get("search_p50_ms")

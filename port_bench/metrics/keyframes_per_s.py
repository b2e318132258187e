"""Keyframes finished per second of the host's clock, over the untraced
window that a traced run makes first: all the window's keyframes over all
its time. The host sets this pace, and its speed swings between runs."""


def read(data):
    return data.window.get("metrics", {}).get("keyframes_per_s")

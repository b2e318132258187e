"""Keyframes sent per forest descent launched (the port's
``ops/forest_cuda.launches`` over the traced window): how many keyframes
the frame worker's batch ladder puts into one descent."""


def read(data):
    launches = data.counters.get("forest_descent_launches", 0)
    if not launches:
        return None
    return data.keyframes / launches

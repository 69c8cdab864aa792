"""The device's idle share of the traced window (torch.profiler, a
scheduled session whose hash-kernel records matched the program's launch
count): 100 x (1 - busy / window)."""


def read(obs):
    dev = obs.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])

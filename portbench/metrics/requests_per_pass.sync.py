"""Requests the scheduler coalesces into one engine pass
(`server/scheduler`): the `evolu_sched_batch_requests` histogram's sum over
its count, both taken over the window."""


def read(obs):
    total, count = obs.get("hist", {}).get("sched_batch_requests", (0.0, 0))
    return total / count if count else None

"""The engine pass (`server/engine.BatchReconciler` under the scheduler):
the `evolu_sched_batch_ms` histogram's sum over its count, both taken over
the window."""


def read(obs):
    total, count = obs.get("hist", {}).get("sched_batch_ms", (0.0, 0))
    return total / count if count else None

"""The storage leg of a pass (`storage/native` packed insert, the tree
folds and the commit): the `host_apply` stage of `obs/anatomy`
(`evolu_stage_ms{stage="host_apply"}`), its sum over its count in the
window. Passes that pushed no rows record no stage."""


def read(obs):
    total, count = obs.get("hist", {}).get("host_apply_ms", (0.0, 0))
    return total / count if count else None

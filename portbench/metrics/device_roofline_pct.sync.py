"""The relay's device leg against its roofline: the least time the rows
the traffic pushed in the window need (hash H by operations, the (owner,
minute) sort and X by bytes; `portbench/peaks.py`), over the device's busy
time in the traced window, in %. The rows are counted from the traffic's
own acknowledged pushes, not from the program's counters."""

from portbench import peaks


def read(obs):
    dev = obs.get("device")
    rows = obs.get("traffic", {}).get("rows_pushed", 0)
    if not dev or dev["busy_s"] <= 0 or not rows:
        return None
    return 100.0 * peaks.relay_leg_least_s(rows)["total_s"] / dev["busy_s"]

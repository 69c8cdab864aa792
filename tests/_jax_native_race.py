"""Race the JAX package's native build (ROADMAP queue 3 item 8): remove
the built `native/*.so` of this checkout, start `procs` processes at once
that each load `libevolu_host.so` and `libevolu_crypto.so`, and count the
loads that came back None; `trials` times over. `plain` loads through the
JAX package's own loader (an unlocked `make`); `locked` through
`_torch_jax_state._load_jax_native`, as the port's parity tests do; `both`
starts half of each at once and counts the locked ones.

    python tests/_jax_native_race.py plain|locked|both [procs] [trials]

It deletes and rebuilds `native/*.so`, so run it where no test run is
using this checkout."""

import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOAD = {
    "plain": "from evolu_tpu.storage import native as h; from evolu_tpu.sync import native_crypto as c",
    "locked": "from _torch_jax_state import _load_jax_native; _load_jax_native(); "
              "from evolu_tpu.storage import native as h; from evolu_tpu.sync import native_crypto as c",
}
CHECK = "; print(h.load_library() is not None and c.load_library() is not None)"


def trial(kinds):
    for so in glob.glob(os.path.join(ROOT, "native", "*.so")):
        os.remove(so)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])}
    procs = [(k, subprocess.Popen([sys.executable, "-c", LOAD[k] + CHECK], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, text=True)) for k in kinds]
    return [(k, p.communicate()[0].strip() == "True") for k, p in procs]


def main() -> None:
    mode = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    trials = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    kinds = ["plain", "locked"] * (n // 2) if mode == "both" else [mode] * n
    counted = "locked" if mode == "both" else mode
    got = [ok for _ in range(trials) for k, ok in trial(kinds) if k == counted]
    print(f"{mode}: {got.count(False)} of {len(got)} {counted} loads got None")


if __name__ == "__main__":
    main()

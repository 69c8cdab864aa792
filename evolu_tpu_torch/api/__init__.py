"""Public bindings: data model validation, the compile-only query
builder, and reactive subscription helpers.

Reference: packages/evolu/src/model.ts (branded column types + casts),
kysely.ts (compile-only query builder), createHooks.ts / useOwner.ts
(React bindings). Python has no React; the binding analog is the
subscription API on `evolu_tpu_torch.runtime.client.Evolu` plus this
package's query builder and model validators.
"""

from evolu_tpu_torch.api import model
from evolu_tpu_torch.api.query import (
    Cond,
    Fn,
    QueryBuilder,
    and_,
    c,
    exists,
    fn,
    not_,
    not_exists,
    or_,
    ref,
    table,
)

__all__ = [
    "model", "QueryBuilder", "table", "fn", "Fn",
    "Cond", "c", "and_", "or_", "not_", "exists", "not_exists", "ref",
    "Hooks", "QueryView", "create_hooks",
]


def __getattr__(name):
    # hooks imports the runtime, which imports api.model — loading hooks
    # lazily keeps `import evolu_tpu_torch.runtime` acyclic.
    if name in ("Hooks", "QueryView", "create_hooks"):
        from evolu_tpu_torch.api import hooks

        return getattr(hooks, name)
    raise AttributeError(f"module 'evolu_tpu_torch.api' has no attribute {name!r}")

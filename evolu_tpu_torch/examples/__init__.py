"""The system's entry points on the port, run as modules:

- `python -m evolu_tpu_torch.examples.relay_server` — the deployable
  relay (`POST /`, `GET /ping`, one SQLite file);
- `python -m evolu_tpu_torch.examples.pod_server` — one pod pass of the
  relay engine over the owner mesh, in one process or a gloo group;
- `python -m evolu_tpu_torch.examples.todo_cli` — the TodoMVC client;
- `python -m evolu_tpu_torch.examples.web_todo` — the web TodoMVC demo.

Each takes `--device` (default: the CUDA card, which they require unless
given `--device cpu`). Importing a module runs nothing."""

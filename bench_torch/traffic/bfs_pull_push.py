"""BFS's query: one call of `BFS.pull_push(source, iterations, threshold,
device_output=True)` on the graph with every weight set to 1, from a
fresh Graph 500 search key each time, drawn from the seed among the
vertices with an out-edge. The answer is the level vector: 1 at the
source, h + 1 where a vertex is first reached at hop h, 0 elsewhere."""
from __future__ import annotations

from graphlily_tpu_torch.apps import BFS
from graphlily_tpu_torch.module import SpMSpVModule, SpMVModule

from graph import out_degree_sources

# (class, method, span name) of the module entries a traced run wraps
SPANS = [(SpMVModule, "apply", "SpMVModule.apply"),
         (SpMSpVModule, "apply_dense", "SpMSpVModule.apply_dense")]

# (class, method) of the app entry that `run` calls; the tests plant
# `alter` there
ENTRY = (BFS, "pull_push")


def make_app(engine_config):
    return BFS(engine_config)


def load(app, csr, config, traffic) -> None:
    app.load_and_format_matrix(csr)
    app.send_matrix_host_to_device()


def queries(graph, config, traffic, gen) -> list:
    return [int(s) for s in out_degree_sources(graph, traffic["sources"],
                                                gen)]


def run(app, config, traffic, source):
    return app.pull_push(source, config["iterations"]["bfs"],
                         traffic["threshold"], device_output=True)


def engines(app) -> list:
    """Each engine once: SpMSpV shares the router engines with SpMV."""
    seen = {}
    for eng in (app.SpMV_.engine, app.SpMSpV_.engine):
        seen.setdefault(id(eng), eng)
    return list(seen.values())


def answer(app, out, num_vertices: int):
    """The answer on the host, in the graph's own vertex ids."""
    return app._external(out.cpu().numpy())[:num_vertices]


def alter(out):
    """The answer made wrong by the least the limits must catch: the
    deepest vertex's level off by one."""
    out = out.clone()
    out[out.argmax()] += 1
    return out

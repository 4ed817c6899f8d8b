"""SSSP's query: one call of `SSSP.pull_push(source, iterations,
threshold, device_output=True)` on a weighted graph, from a fresh source
each time, drawn from the seed among the vertices with an out-edge."""
from __future__ import annotations

from graphlily_tpu_torch.apps import SSSP
from graphlily_tpu_torch.module import SpMSpVModule, SpMVModule

from graph import out_degree_sources

# (class, method, span name) of the module entries a traced run wraps
SPANS = [(SpMVModule, "apply", "SpMVModule.apply"),
         (SpMSpVModule, "apply_dense", "SpMSpVModule.apply_dense")]

# (class, method) of the app entry that `run` calls; the tests plant
# `alter` there
ENTRY = (SSSP, "pull_push")


def make_app(engine_config):
    return SSSP(engine_config)


def load(app, csr, config, traffic) -> None:
    app.load_and_format_matrix(csr, unit_weights=False)
    app.send_matrix_host_to_device()


def queries(graph, config, traffic, gen) -> list:
    return [int(s) for s in out_degree_sources(graph, traffic["sources"],
                                                gen)]


def run(app, config, traffic, source):
    return app.pull_push(source, config["iterations"]["sssp"],
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
    farthest reached vertex's distance off by a thousandth."""
    out = out.clone()
    far = out.where(out < 1e8, 0.0).argmax()
    out[far] *= 1.001
    return out

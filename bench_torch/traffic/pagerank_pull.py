"""PageRank's query: one call of `PageRank.pull(damping, iterations,
device_output=True)` on a graph formatted once with that damping. Every
query is the same call; the answer stays on the card."""
from __future__ import annotations

from graphlily_tpu_torch.apps import PageRank
from graphlily_tpu_torch.module import SpMVModule

# (class, method, span name) of the module entries a traced run wraps
SPANS = [(SpMVModule, "apply", "SpMVModule.apply")]

# (class, method) of the app entry that `run` calls; the tests plant
# `alter` there
ENTRY = (PageRank, "pull")


def make_app(engine_config):
    return PageRank(engine_config)


def load(app, csr, config, traffic) -> None:
    app.load_and_format_matrix(csr, damping=traffic["damping"])
    app.send_matrix_host_to_device()


def queries(graph, config, traffic, gen) -> list:
    return [None]


def run(app, config, traffic, query):
    return app.pull(traffic["damping"], traffic["iterations"],
                    device_output=True)


def engines(app) -> list:
    return [app.SpMV_.engine]


def answer(app, out, num_vertices: int):
    """The answer on the host, in the graph's own vertex ids."""
    return app._external(out.cpu().numpy())[:num_vertices]


def alter(out):
    """The answer made wrong by the least the limits must catch: vertex
    0's rank off by a thousandth."""
    out = out.clone()
    out[0] *= 1.001
    return out

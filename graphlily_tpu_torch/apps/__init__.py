from .module_collection import ModuleCollection
from .bfs import BFS
from .pagerank import PageRank
from .sssp import SSSP

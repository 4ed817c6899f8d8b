from .vector import (SparseVector, sparse_from_entries, sparse_to_dense,
                     dense_to_sparse)
from .reference import (COODevice, coo_from_csr, coo_from_csc, spmv_coo,
                        spmspv_coo, ewise_add_scalar, assign_vector_dense,
                        assign_vector_sparse_no_new_frontier,
                        assign_vector_sparse_new_frontier)
from .router import RouterSpMV, RouterArrays
from .planar import PlanarSpMV, PlanarArrays
from .chunked import ChunkedSpMV, ChunkArrays
from .tropical import TropicalSpMV, TropicalStages, TropicalArrays

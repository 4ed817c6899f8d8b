from .reference import (COODevice, coo_from_csr, spmv_coo, ewise_add_scalar,
                        assign_vector_dense)
from .router import RouterSpMV, RouterArrays
from .planar import PlanarSpMV, PlanarArrays
from .chunked import ChunkedSpMV, ChunkArrays

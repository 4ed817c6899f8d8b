from .matrix import (CSRMatrix, CSCMatrix, csr2csc, csc2csr, csr_from_coo,
                     load_csr_matrix_from_float_npz)
from .formatter import (util_round_csr_matrix_dim,
                        util_normalize_csr_matrix_by_outdegree, permute_rows,
                        symmetric_permute, degree_sort_permutation,
                        estimate_chunk_layout_gb, add_self_edges_for_sssp,
                        ChunkedSpMVLayout, pack_csr_chunks)
from .generate import (uniform_csr, dense_csr, conflict_csr, rmat_csr,
                       iccad_standin, ICCAD_GRAPHS)
from .router_format import (RouterSpMVLayout, choose_region_rows,
                            pack_router, deposit_targets)
from .planar_format import (PlanarSpMVLayout, choose_planar_region_rows,
                            pack_planar, planes_to_triples)
from .permc_format import pack_permc, permc_stream_rows
from .tropical_format import (TropicalSpMVLayout, pack_tropical,
                              pack_tropical_pass1, pack_tropical_schedule,
                              choose_tropical_region_rows,
                              resolve_tropical_split_format)

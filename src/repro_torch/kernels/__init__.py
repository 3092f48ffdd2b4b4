"""The port's kernels and the plan/execute API.

api.py              plan/execute: typed GemmSpec/Epilogue, capability-based
                    backend registry (torch | ref | cuda_mesh), plan cache
mesh_matmul.py      K1, the mesh-array GEMM (CUDA kernel + plain version)
paged_attention.py  K2, paged decode attention (CUDA kernel + plain version)
                    behind the cuda_paged / torch_gather door
ref.py              plain-torch oracles the kernels are tested against
_build.py           nvcc build + ctypes loading of csrc/*.cu
"""

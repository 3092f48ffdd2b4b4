"""The port's kernels and the plan/execute API.

api.py              plan/execute: typed GemmSpec/Epilogue, capability-based
                    backend registry (torch | ref | cuda_mesh), plan cache,
                    the mesh GEMM's autograd Function (the `_mm` VJP)
mesh_matmul.py      K1, the mesh-array GEMM (CUDA kernel + plain version)
paged_attention.py  K4, paged decode attention (CUDA kernel + plain version)
                    behind the cuda_paged / torch_gather door
scramble.py         K3, the block scramble S^k (CUDA kernel + plain version)
grouped.py          K5, the grouped (MoE) mesh GEMM (CUDA kernel + plain version)
flash_attention.py  K6, flash attention for the chunked prefill / training
                    path (CUDA kernel + plain version, recompute backward)
rmsnorm.py          R1, rmsnorm with a fixed order of summation per row (CUDA
                    kernel + plain version; the port's own, no Pallas kernel)
ops.py              scramble_blocks with its gradient (S^-k), and the legacy
                    `matmul` shim over plan/execute
ref.py              plain-torch oracles the kernels are tested against
_build.py           nvcc build + ctypes loading of csrc/*.cu
"""

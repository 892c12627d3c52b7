"""The benchmark of diffusion_model_project_tpu_torch on one NVIDIA H100.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

"""The benchmark of the PyTorch port (``point_diffusion_refinement_tpu_torch``)
on one H100: ``python3 -m pdr_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, driven by ``BENCHMARK.json``."""

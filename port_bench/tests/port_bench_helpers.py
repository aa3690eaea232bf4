"""Helpers of the benchmark's tests."""


def tiny_cell(name: str = "xz_T0_preset0.bulk", block_size: int = 1024,
              per_call: int = 3, pool: int = 4, tail: int = 100,
              check: int = 2):
    """A cell of BENCHMARK.json cut to a size the CPU's plain K1 decodes in
    a second or two: files of ``per_call`` blocks and a short one of
    ``tail`` bytes, from a pool of ``pool`` full blocks (under a folder of
    its own name)."""
    from port_bench import spec
    cell = spec.cell(spec.load(), name)
    cell.config.update(name="tiny_" + cell.config["name"],
                       block_size=block_size)
    cell.traffic.update(file_bytes=per_call * block_size + tail,
                        pool_per_file=pool / per_call, check_calls=check)
    return cell

"""The kernel build's -Xptxas -v report (tpujpeg_torch.kernels.build):
registers, stack and spill bytes per kernel, read from nvcc's output. The
build itself needs nvcc and runs only where the card is; the parser is
held here to output in nvcc's format."""

from tpujpeg_torch.kernels import build

PTXAS = """\
ptxas info    : 0 bytes gmem, 64 bytes cmem[4]
ptxas info    : Compiling entry function '_Z21prog_ac_refine_kernel6AcArgs' for 'sm_90a'
ptxas info    : Function properties for _Z21prog_ac_refine_kernel6AcArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 1 barriers, 1600 bytes smem, 440 bytes cmem[0]
ptxas info    : Function properties for _Z9helper_fni
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z23wavefront_pixels_kernel8LaneArgs7Outputs' for 'sm_90a'
ptxas info    : Function properties for _Z23wavefront_pixels_kernel8LaneArgs7Outputs
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 536 bytes cmem[0]
ptxas info    : Compiling entry function 'tj_plain_c_kernel' for 'sm_90a'
ptxas info    : Function properties for tj_plain_c_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 380 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_entry():
    assert build.parse_ptxas(PTXAS) == {
        "prog_ac_refine_kernel": dict(registers=104, smem=1600, stack=0, spill_stores=0, spill_loads=0),
        "wavefront_pixels_kernel": dict(registers=255, smem=0, stack=16, spill_stores=8, spill_loads=12),
        "tj_plain_c_kernel": dict(registers=12, smem=0, stack=0, spill_stores=0, spill_loads=0),
    }


TEMPLATES = """\
ptxas info    : Compiling entry function '_Z16h2v2_tile_kernelILb1ELb0EEv5PlaneS0_S0_iiiiiPh' for 'sm_90a'
ptxas info    : Function properties for _Z16h2v2_tile_kernelILb1ELb0EEv5PlaneS0_S0_iiiiiPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 3200 bytes smem, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16h2v2_tile_kernelILb0ELb0EEv5PlaneS0_S0_iiiiiPh' for 'sm_90a'
ptxas info    : Function properties for _Z16h2v2_tile_kernelILb0ELb0EEv5PlaneS0_S0_iiiiiPh
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 3200 bytes smem, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21color_444_tile_kernelILb1EEv5PlaneS0_S0_iiPh' for 'sm_90a'
ptxas info    : Function properties for _Z21color_444_tile_kernelILb1EEv5PlaneS0_S0_iiPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, 412 bytes cmem[0]
"""


def test_parse_ptxas_keeps_template_instances_apart():
    """Each instance of a kernel template is its own entry, named with
    its template arguments' values."""
    assert build.parse_ptxas(TEMPLATES) == {
        "h2v2_tile_kernel<1,0>": dict(registers=48, smem=3200, stack=0, spill_stores=0, spill_loads=0),
        "h2v2_tile_kernel<0,0>": dict(registers=64, smem=3200, stack=8, spill_stores=4, spill_loads=4),
        "color_444_tile_kernel<1>": dict(registers=20, smem=0, stack=0, spill_stores=0, spill_loads=0),
    }


def test_ptxas_report_is_none_before_a_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    assert build.ptxas_report() is None
    assert "-v" in build.FLAGS and "-Xptxas" in build.FLAGS

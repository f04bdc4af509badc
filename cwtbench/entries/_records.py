"""What the CWT entry points share: records cycled call by call, and the
configuration's scale grid, built by the program's ``build_scale_grid`` as
a user builds it and held on the device."""
import torch

from cwtbench import kernel_bounds


class RecordsEntry:
    output = kernel_output = None     # set by each entry

    def __init__(self, cell, inputs, *, seed, device, precision):
        import pycwt_torch as pt
        from pycwt_torch.transform import build_scale_grid

        cfg = cell.config
        self.x = inputs["x"]
        self.records, self.n0 = self.x.shape
        self.dt, self.f0 = float(cfg["dt"]), float(cfg["f0"])
        self.dj, self.s0 = float(cfg["dj"]), float(cfg["s0_dt"]) * self.dt
        self.S = int(cfg["J"]) + 1
        self.nfft = 1 << (self.n0 - 1).bit_length()
        self.mother = pt.Morlet(self.f0)
        grid = build_scale_grid(self.n0, self.dt, dj=self.dj, s0=self.s0,
                                J=int(cfg["J"]), mother=self.mother)
        self.scales = torch.as_tensor(grid.sj, dtype=torch.float32, device=device)
        self.precision = precision
        self.shape = {"kind": "cwt", "B": 1, "n0": self.n0, "nfft": self.nfft,
                      "S": self.S, "output": self.output,
                      "kernel_output": self.kernel_output}

    def warm(self):
        for i in range(2):
            self.call(i)

    def units(self, i):
        return self.n0 * self.S

    def kernel_bounds(self):
        return kernel_bounds.k1_k2(self.shape, self.nfft // 2)

    def release(self):
        self.scales = None

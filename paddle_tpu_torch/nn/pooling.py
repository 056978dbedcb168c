"""Pooling layers: the port of ``paddle_tpu/nn/pooling.py`` (the unpools
and fractional pools wait for ROADMAP A12)."""

from __future__ import annotations

from torch import nn

from . import functional as F


class _Pool(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format=None, exclusive=True,
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format
        self.exclusive = exclusive


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCL")


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCHW")


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCDHW")


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode,
                            self.data_format or "NCL")


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            data_format=self.data_format or "NCHW")


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            data_format=self.data_format or "NCDHW")


class _Adaptive(nn.Module):
    def __init__(self, output_size, data_format=None, return_mask=False):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format
        self.return_mask = return_mask


class AdaptiveAvgPool1D(_Adaptive):
    def __init__(self, output_size, name=None):
        super().__init__(output_size)

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(_Adaptive):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask=return_mask)

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class LPPool1D(nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(nn.Module):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode,
                     data_format)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)

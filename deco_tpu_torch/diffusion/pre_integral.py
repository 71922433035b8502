"""Closed-form integrals of Lagrange interpolation bases, orders 1-4
(``deco_tpu/diffusion/pre_integral.py``).

The Adams-Lagrange multistep sampler precomputes its per-step coefficients
with these, in plain Python floats. Each ``lagrange_preint_oK`` integrates
the K Lagrange basis polynomials over ``[int_t_start, int_t_end]`` and
returns the weighted value combination and the basis coefficients
normalised to sum to one.
"""

from __future__ import annotations


def lagrange_preint_o1(t1, v1, int_t_start, int_t_end):
    int1 = int_t_end - int_t_start
    return int1 * v1, (int1 / int1,)


def lagrange_preint_o2(t1, t2, v1, v2, int_t_start, int_t_end):
    int1 = 0.5 / (t1 - t2) * ((int_t_end - t2) ** 2 - (int_t_start - t2) ** 2)
    int2 = 0.5 / (t2 - t1) * ((int_t_end - t1) ** 2 - (int_t_start - t1) ** 2)
    int_sum = int1 + int2
    return int1 * v1 + int2 * v2, (int1 / int_sum, int2 / int_sum)


def _basis3(ta, o1, o2, s, e):
    """Integral of (x-o1)(x-o2) / ((ta-o1)(ta-o2)) over [s, e]."""
    denom = (ta - o1) * (ta - o2)
    f = lambda x: (1.0 / 3.0) * x**3 - 0.5 * (o1 + o2) * x**2 + (o1 * o2) * x
    return (f(e) - f(s)) / denom


def lagrange_preint_o3(t1, t2, t3, v1, v2, v3, int_t_start, int_t_end):
    int1 = _basis3(t1, t2, t3, int_t_start, int_t_end)
    int2 = _basis3(t2, t1, t3, int_t_start, int_t_end)
    int3 = _basis3(t3, t1, t2, int_t_start, int_t_end)
    int_sum = int1 + int2 + int3
    return (
        int1 * v1 + int2 * v2 + int3 * v3,
        (int1 / int_sum, int2 / int_sum, int3 / int_sum),
    )


def _basis4(o1, o2, o3, denom, s, e):
    """Integral of (x-o1)(x-o2)(x-o3)/denom over [s, e]."""
    f = lambda x: (
        0.25 * x**4
        - (1.0 / 3.0) * (o1 + o2 + o3) * x**3
        + 0.5 * (o1 * o2 + o1 * o3 + o2 * o3) * x**2
        - (o1 * o2 * o3) * x
    )
    return (f(e) - f(s)) / denom


def lagrange_preint_o4(t1, t2, t3, t4, v1, v2, v3, v4, int_t_start, int_t_end):
    int1 = _basis4(t2, t3, t4, (t1 - t2) * (t1 - t3) * (t1 - t4), int_t_start, int_t_end)
    int2 = _basis4(t1, t3, t4, (t2 - t1) * (t2 - t3) * (t2 - t4), int_t_start, int_t_end)
    int3 = _basis4(t1, t2, t4, (t3 - t1) * (t3 - t2) * (t3 - t4), int_t_start, int_t_end)
    int4 = _basis4(t1, t2, t3, (t4 - t1) * (t4 - t2) * (t4 - t3), int_t_start, int_t_end)
    int_sum = int1 + int2 + int3 + int4
    return (
        int1 * v1 + int2 * v2 + int3 * v3 + int4 * v4,
        (int1 / int_sum, int2 / int_sum, int3 / int_sum, int4 / int_sum),
    )


def lagrange_preint(order, pre_vs, pre_ts, int_t_start, int_t_end):
    """Integrate the Lagrange interpolant of the last ``order`` (t, v) samples.

    Returns ``(integrated_value, coeffs)``; coeffs are normalized to sum to 1.
    """
    order = min(order, len(pre_vs), len(pre_ts))
    if order == 1:
        return lagrange_preint_o1(pre_ts[-1], pre_vs[-1], int_t_start, int_t_end)
    elif order == 2:
        return lagrange_preint_o2(
            pre_ts[-2], pre_ts[-1], pre_vs[-2], pre_vs[-1], int_t_start, int_t_end
        )
    elif order == 3:
        return lagrange_preint_o3(
            pre_ts[-3], pre_ts[-2], pre_ts[-1],
            pre_vs[-3], pre_vs[-2], pre_vs[-1],
            int_t_start, int_t_end,
        )
    elif order == 4:
        return lagrange_preint_o4(
            pre_ts[-4], pre_ts[-3], pre_ts[-2], pre_ts[-1],
            pre_vs[-4], pre_vs[-3], pre_vs[-2], pre_vs[-1],
            int_t_start, int_t_end,
        )
    raise ValueError("Invalid order")


def polynomial_integral(coeffs, int_t_start, int_t_end):
    """Integrate sum_o coeffs[o] * x^o over [int_t_start, int_t_end]."""
    val = 0.0
    for o, c in enumerate(coeffs):
        val += c / (o + 1) * (int_t_end ** (o + 1) - int_t_start ** (o + 1))
    return val

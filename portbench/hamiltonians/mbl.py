"""The random-field Heisenberg chain of dynamite's many-body localization
study (``examples/scripts/MBL/run_mbl.py``) as a term list.

H = sum_i 1/4 (X_i X_{i+1} + Y_i Y_{i+1} + Z_i Z_{i+1}) + sum_i 1/2 f_i Z_i
over the open chain, with one disorder realization's fields ``f_i`` drawn
uniformly from [-h, h]. A term is ``(coefficient, ((site, letter), ...))``.
"""


def draw_fields(params, L, rng):
    """One realization's fields from a numpy Generator."""
    h = params['h']
    return [float(f) for f in rng.uniform(-h, h, L)]


def terms(params, L, fields):
    out = []
    for i in range(L - 1):
        out += [(0.25, ((i, s), (i + 1, s))) for s in 'XYZ']
    out += [(0.5 * f, ((i, 'Z'),)) for i, f in enumerate(fields)]
    return out

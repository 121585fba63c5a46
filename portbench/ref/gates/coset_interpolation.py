"""CosetInterpolationGate: evaluate, at an extension point, the interpolant
of values given on a shifted multiplicative coset.

Host copy of `plonky2_tpu/gates/coset_interpolation.py`, wire for wire:
the primitive the recursive FRI verifier uses to check one arity-2^k fold
step from the opened leaf values.  This is the JAX package's own design,
not plonky2's chunked barycentric gate: it proves the evaluation by the
even/odd folding identity the FRI fold itself uses, which keeps every
constraint at degree <= 3:

Given p of degree < M with values v_i on coset s*H (|H| = M, generator g),
split p(X) = pe(X^2) + X*po(X^2).  Then for x = s*g^i (note -x = s*g^(i+M/2)):
    pe(x^2) = (p(x) + p(-x)) / 2
    po(x^2) = (p(x) - p(-x)) / (2x)
and q(Y) = pe(Y) + z_r * po(Y) satisfies q(z_r^2) = p(z_r) with q's values
on the squared coset s^2*H^2.  Repeating k = log2(N) times reduces to a
single value, which must equal the claimed evaluation.

Division is witness-hinted: aux wires w_{r,i} = po(x^2) carry the quotient
and the gate checks `2*x*w == a - b` (degree 2, since x = s_r * g_r^i with
s_r an aux wire and g_r^i a compile-time constant).  Its generator has no
op spec, so the witness tape runs it as a Python escape, as the JAX tape
does.
"""

from __future__ import annotations

from ..field import ext, gl
from ..witness import LambdaGenerator
from .base import Gate

D = 2
_INV2 = pow(2, gl.P - 2, gl.P)


class CosetInterpolationGate(Gate):
    def __init__(self, subgroup_bits: int):
        if subgroup_bits < 1:
            raise ValueError(
                f"CosetInterpolationGate needs subgroup_bits >= 1, got {subgroup_bits}")
        self.subgroup_bits = subgroup_bits

    @property
    def n_points(self) -> int:
        return 1 << self.subgroup_bits

    def key(self) -> str:
        return f"CosetInterpolation(subgroup_bits={self.subgroup_bits})"

    # ---- wire layout ----
    # routed: shift (1) | values (N*D) | z (D) | output (D)
    # aux, per round r in 0..k-1 with M = N >> r, half = M//2:
    #   w_{r,i}        half ext slots   (the hinted odd-part quotients)
    #   folded v_{r+1} half ext slots   (next level values; last round's
    #                                    single value is constrained == output)
    #   z_{r+1} (D) and s_{r+1} (1)     for r+1 < k

    WIRE_SHIFT = 0

    @property
    def wire_values(self):
        return 1

    @property
    def wire_z(self):
        return 1 + self.n_points * D

    @property
    def wire_output(self):
        return self.wire_z + D

    @property
    def num_routed(self):
        return self.wire_output + D

    def _aux_layout(self):
        """Returns (w[r][i], v[r][i], zs[r], ss[r]) -> wire index maps.
        v[r] are the level-(r+1) folded values; zs[r] = z^(2^(r+1)),
        ss[r] = s^(2^(r+1)) (only for r+1 < k)."""
        pos = self.num_routed
        k = self.subgroup_bits
        w, v, zs, ss = [], [], [], []
        for r in range(k):
            half = self.n_points >> (r + 1)
            w.append([pos + D * i for i in range(half)])
            pos += D * half
            v.append([pos + D * i for i in range(half)])
            pos += D * half
            if r + 1 < k:
                zs.append(pos)
                pos += D
                ss.append(pos)
                pos += 1
        return w, v, zs, ss, pos

    @property
    def num_wires(self):
        return self._aux_layout()[4]

    @property
    def degree(self):
        return 2  # every constraint is a product of at most two wires

    @property
    def num_constraints(self):
        k = self.subgroup_bits
        # per round: half * (D w-checks + D fold-checks); plus D + 1 square
        # chains per non-final round; plus D output equality.
        n = 0
        for r in range(k):
            half = self.n_points >> (r + 1)
            n += 2 * D * half
            if r + 1 < k:
                n += D + 1
        return n + D

    def eval(self, vars, alg):
        wl = vars.local_wires
        k = self.subgroup_bits
        w, v, zs, ss, _ = self._aux_layout()

        def ext_at(base):
            return (wl[base], wl[base + 1])

        out = []
        values = [ext_at(self.wire_values + D * i) for i in range(self.n_points)]
        z = ext_at(self.wire_z)
        s = wl[self.WIRE_SHIFT]
        for r in range(k):
            M = self.n_points >> r
            half = M // 2
            g = gl.primitive_root_of_unity(self.subgroup_bits - r)
            nxt = []
            for i in range(half):
                a, b = values[i], values[i + half]
                wi = ext_at(w[r][i])
                # 2 * s_r * g^i * w == a - b   (componentwise)
                coeff = (2 * pow(g, i, gl.P)) % gl.P
                sw = alg.mul_const(coeff, s)
                out.append(alg.sub(alg.mul(sw, wi[0]), alg.sub(a[0], b[0])))
                out.append(alg.sub(alg.mul(sw, wi[1]), alg.sub(a[1], b[1])))
                # v' == (a + b)/2 + z_r * w   (ext product z*w)
                zw = (alg.add(alg.mul(z[0], wi[0]),
                              alg.mul_const(ext.W, alg.mul(z[1], wi[1]))),
                      alg.add(alg.mul(z[0], wi[1]), alg.mul(z[1], wi[0])))
                vi = ext_at(v[r][i])
                for c in range(D):
                    mean = alg.mul_const(_INV2, alg.add(a[c], b[c]))
                    out.append(alg.sub(vi[c], alg.add(mean, zw[c])))
                nxt.append(vi)
            values = nxt
            if r + 1 < k:
                # z_{r+1} == z_r^2, s_{r+1} == s_r^2
                z2 = ext_at(zs[r])
                zz = (alg.add(alg.mul(z[0], z[0]),
                              alg.mul_const(ext.W, alg.mul(z[1], z[1]))),
                      alg.mul_const(2, alg.mul(z[0], z[1])))
                out.append(alg.sub(z2[0], zz[0]))
                out.append(alg.sub(z2[1], zz[1]))
                s2 = wl[ss[r]]
                out.append(alg.sub(s2, alg.mul(s, s)))
                z, s = z2, s2
        o = ext_at(self.wire_output)
        out.append(alg.sub(o[0], values[0][0]))
        out.append(alg.sub(o[1], values[0][1]))
        return out

    def generators(self, row, constants):
        from ..ir.builder import Wire
        k = self.subgroup_bits
        w, v, zs, ss, _ = self._aux_layout()

        def fn(vals, row=row):
            s = vals[0]
            values = [tuple(vals[1 + 2 * i:3 + 2 * i])
                      for i in range(self.n_points)]
            z = tuple(vals[1 + 2 * self.n_points:3 + 2 * self.n_points])
            outs = []
            for r in range(k):
                half = self.n_points >> (r + 1)
                g = gl.primitive_root_of_unity(self.subgroup_bits - r)
                nxt = []
                for i in range(half):
                    a, b = values[i], values[i + half]
                    x = (s * pow(g, i, gl.P)) % gl.P
                    inv2x = pow(2 * x % gl.P, gl.P - 2, gl.P)
                    wi = ext.scalar_mul_s(ext.sub_s(a, b), inv2x)
                    vi = ext.add_s(ext.scalar_mul_s(ext.add_s(a, b), _INV2),
                                   ext.mul_s(z, wi))
                    outs.append((Wire(row, w[r][i]), wi[0]))
                    outs.append((Wire(row, w[r][i] + 1), wi[1]))
                    outs.append((Wire(row, v[r][i]), vi[0]))
                    outs.append((Wire(row, v[r][i] + 1), vi[1]))
                    nxt.append(vi)
                values = nxt
                if r + 1 < k:
                    z = ext.mul_s(z, z)
                    s = (s * s) % gl.P
                    outs.append((Wire(row, zs[r]), z[0]))
                    outs.append((Wire(row, zs[r] + 1), z[1]))
                    outs.append((Wire(row, ss[r]), s))
            outs.append((Wire(row, self.wire_output), values[0][0]))
            outs.append((Wire(row, self.wire_output + 1), values[0][1]))
            return outs

        deps = [Wire(row, self.WIRE_SHIFT)]
        deps += [Wire(row, self.wire_values + j)
                 for j in range(self.n_points * D)]
        deps += [Wire(row, self.wire_z), Wire(row, self.wire_z + 1)]
        out_wires = []
        for r in range(k):
            half = self.n_points >> (r + 1)
            for i in range(half):
                out_wires += [Wire(row, w[r][i]), Wire(row, w[r][i] + 1),
                              Wire(row, v[r][i]), Wire(row, v[r][i] + 1)]
            if r + 1 < k:
                out_wires += [Wire(row, zs[r]), Wire(row, zs[r] + 1),
                              Wire(row, ss[r])]
        out_wires += [Wire(row, self.wire_output),
                      Wire(row, self.wire_output + 1)]
        return [LambdaGenerator(deps, fn, outs=out_wires)]

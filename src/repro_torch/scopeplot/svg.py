"""A drawing surface that writes SVG with the standard library.

The reference draws its plots with matplotlib's Agg backend
(``src/repro/scopeplot/plot.py``).  The port keeps no such dependency,
so that a report renders on a host that has only the standard
library and numpy: :func:`subplots` returns a :class:`Figure` and an
:class:`Axes` that take exactly the calls the renderers make
(``errorbar``, ``bar``, ``barh``, ``plot``, ``axvline``, ``annotate``,
the tick, label, scale, grid and legend setters) with matplotlib's
meaning, keep what each call drew (``Axes.artists``) and every call as
given (``Axes.calls``), and :meth:`Figure.savefig` writes one SVG: the
frame, linear and log ticks, the grid, bars and lines with markers,
error bars, dashed fit lines, annotations, a legend and a title.

Every drawn data element carries ``class="mark"``, so a reader can
count what a plot holds without rendering it.  A bar whose height is
NaN (the gap ``grouped_bar`` leaves for a missing category) draws
nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple
from xml.sax.saxutils import escape, quoteattr

#: matplotlib's default color cycle (``tab10``).
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
#: The named colors the renderers pass; any other is written as given.
_NAMED = {"k": "#000000", "tab:green": CYCLE[2], "tab:red": CYCLE[3]}
#: matplotlib's defaults, in points.
_FONT_PT = 10.0
_TITLE_PT = 12.0
_TICK_PT = 3.5
_PAD_PT = 4.0


def _resolve_color(spec: Optional[str], default: str) -> str:
    if spec is None:
        return default
    return _NAMED.get(spec, spec)


def _floats(values: Any) -> List[float]:
    if values is None:
        return []
    if isinstance(values, (int, float)):
        return [float(values)]
    return [float(v) for v in values]


def _broadcast(values: Any, n: int) -> Optional[List[float]]:
    if values is None:
        return None
    vals = _floats(values)
    return vals * n if len(vals) == 1 and n != 1 else vals


def _parse_fmt(fmt: str) -> Tuple[Optional[str], Optional[str]]:
    """(linestyle, marker) of the matplotlib format strings the
    renderers pass: ``--`` (dashed, no marker), ``o`` (markers, no
    line), ``-o``; "" is a solid line."""
    if not fmt:
        return "-", None
    linestyle = "--" if "--" in fmt else ("-" if "-" in fmt else None)
    return linestyle, "o" if "o" in fmt else None


@dataclass
class Line:
    """A ``plot`` or ``errorbar`` call (``kind``): points, optional
    symmetric y errors, a line style (``None``: markers only) and a
    marker."""
    kind: str
    x: List[float]
    y: List[float]
    label: Optional[str]
    color: str
    linestyle: Optional[str] = "-"
    marker: Optional[str] = None
    yerr: Optional[List[float]] = None
    capsize: float = 0.0


@dataclass
class Bars:
    """A ``bar`` (vertical) or ``barh`` call: bar centers, lengths from
    zero, thickness, optional errors along the length."""
    pos: List[float]
    values: List[float]
    thickness: float
    label: Optional[str]
    colors: List[str]
    horizontal: bool = False
    alpha: float = 1.0
    err: Optional[List[float]] = None
    capsize: float = 0.0


@dataclass
class VLine:
    x: float
    color: str
    linewidth: float


@dataclass
class Annotation:
    text: str
    xy: Tuple[float, float]
    offset: Tuple[float, float]          # points
    va: str
    fontsize: float


@dataclass
class Axis:
    """One axis's settings, as the setters left them."""
    label: str = ""
    scale: str = "linear"
    base: float = 10.0
    ticks: Optional[List[float]] = None
    ticklabels: Optional[List[str]] = None
    rotation: float = 0.0
    ha: Optional[str] = None
    fontsize: float = _FONT_PT
    margin: float = 0.05
    inverted: bool = False


@dataclass
class Axes:
    """The recorded drawing: artists in call order and the axes'
    settings.  ``calls`` keeps every call's name, positional and
    keyword arguments as given."""
    calls: List[Tuple[str, tuple, dict]] = field(default_factory=list)
    artists: List[Any] = field(default_factory=list)
    xaxis: Axis = field(default_factory=Axis)
    yaxis: Axis = field(default_factory=Axis)
    title: str = ""
    grid_alpha: Optional[float] = None
    legend_fontsize: Optional[float] = None
    _lines_drawn: int = 0
    _patches_drawn: int = 0

    def _record(self, name: str, args: tuple, kwargs: dict) -> None:
        self.calls.append((name, args, kwargs))

    def _next_line_color(self) -> str:
        c = CYCLE[self._lines_drawn % len(CYCLE)]
        self._lines_drawn += 1
        return c

    def _next_patch_color(self) -> str:
        c = CYCLE[self._patches_drawn % len(CYCLE)]
        self._patches_drawn += 1
        return c

    # -- data ------------------------------------------------------------
    def errorbar(self, x, y, yerr=None, fmt: str = "", marker=None,
                 label=None, capsize=None, **kwargs) -> Line:
        self._record("errorbar", (x, y), dict(
            yerr=yerr, fmt=fmt, marker=marker, label=label,
            capsize=capsize, **kwargs))
        xs, ys = _floats(x), _floats(y)
        linestyle, fmt_marker = _parse_fmt(fmt)
        line = Line("errorbar", xs, ys, label, self._next_line_color(),
                    linestyle, marker or fmt_marker,
                    _broadcast(yerr, len(ys)), float(capsize or 0.0))
        self.artists.append(line)
        return line

    def plot(self, x, y, fmt: Optional[str] = None, marker=None,
             label=None, **kwargs) -> Line:
        self._record("plot", (x, y) if fmt is None else (x, y, fmt),
                     dict(marker=marker, label=label, **kwargs))
        linestyle, fmt_marker = _parse_fmt(fmt or "")
        line = Line("plot", _floats(x), _floats(y), label,
                    self._next_line_color(), linestyle,
                    marker or fmt_marker)
        self.artists.append(line)
        return line

    def _bars(self, name, pos, values, thickness, label, err, capsize,
              colors, alpha, horizontal, kwargs) -> Bars:
        self._record(name, (pos, values), dict(
            label=label, capsize=capsize, color=colors, alpha=alpha,
            **({"xerr" if horizontal else "yerr": err}),
            **({"height" if horizontal else "width": thickness}),
            **kwargs))
        p, v = _floats(pos), _floats(values)
        if colors is None or isinstance(colors, str):
            cols = [_resolve_color(colors, self._next_patch_color())] \
                * len(v)
        else:
            cols = [_resolve_color(c, CYCLE[0]) for c in colors]
        bars = Bars(p, v, float(thickness), label, cols, horizontal,
                    1.0 if alpha is None else float(alpha),
                    _broadcast(err, len(v)), float(capsize or 0.0))
        self.artists.append(bars)
        return bars

    def bar(self, x, height, width=0.8, label=None, yerr=None,
            capsize=None, color=None, alpha=None, **kwargs) -> Bars:
        return self._bars("bar", x, height, width, label, yerr, capsize,
                          color, alpha, False, kwargs)

    def barh(self, y, width, height=0.8, label=None, xerr=None,
             capsize=None, color=None, alpha=None, **kwargs) -> Bars:
        return self._bars("barh", y, width, height, label, xerr, capsize,
                          color, alpha, True, kwargs)

    def axvline(self, x=0.0, color=None, linewidth=None, **kwargs) -> VLine:
        self._record("axvline", (x,), dict(color=color, linewidth=linewidth,
                                           **kwargs))
        line = VLine(float(x), _resolve_color(color, CYCLE[0]),
                     float(linewidth or 1.5))
        self.artists.append(line)
        return line

    def annotate(self, text, xy, xytext=None, textcoords=None, va=None,
                 fontsize=None, **kwargs) -> Annotation:
        self._record("annotate", (text, xy), dict(
            xytext=xytext, textcoords=textcoords, va=va, fontsize=fontsize,
            **kwargs))
        if textcoords not in (None, "offset points"):
            raise ValueError(f"textcoords {textcoords!r} is not supported")
        offset = (0.0, 0.0) if textcoords is None else \
            (float(xytext[0]), float(xytext[1]))
        note = Annotation(str(text), (float(xy[0]), float(xy[1])), offset,
                          va or "baseline", float(fontsize or _FONT_PT))
        self.artists.append(note)
        return note

    # -- axes ------------------------------------------------------------
    def set_xticks(self, ticks) -> None:
        self._record("set_xticks", (ticks,), {})
        self.xaxis.ticks = _floats(ticks)

    def set_yticks(self, ticks) -> None:
        self._record("set_yticks", (ticks,), {})
        self.yaxis.ticks = _floats(ticks)

    def set_xticklabels(self, labels, rotation=0, ha=None, fontsize=None,
                        **kwargs) -> None:
        self._record("set_xticklabels", (labels,), dict(
            rotation=rotation, ha=ha, fontsize=fontsize, **kwargs))
        self.xaxis.ticklabels = [str(s) for s in labels]
        self.xaxis.rotation = float(rotation)
        self.xaxis.ha = ha
        self.xaxis.fontsize = float(fontsize or _FONT_PT)

    def set_yticklabels(self, labels, fontsize=None, **kwargs) -> None:
        self._record("set_yticklabels", (labels,), dict(fontsize=fontsize,
                                                        **kwargs))
        self.yaxis.ticklabels = [str(s) for s in labels]
        self.yaxis.fontsize = float(fontsize or _FONT_PT)

    def invert_yaxis(self) -> None:
        self._record("invert_yaxis", (), {})
        self.yaxis.inverted = not self.yaxis.inverted

    def margins(self, x=None, y=None) -> None:
        self._record("margins", (), dict(x=x, y=y))
        if x is not None:
            self.xaxis.margin = float(x)
        if y is not None:
            self.yaxis.margin = float(y)

    def set_xlabel(self, label) -> None:
        self._record("set_xlabel", (label,), {})
        self.xaxis.label = str(label)

    def set_ylabel(self, label) -> None:
        self._record("set_ylabel", (label,), {})
        self.yaxis.label = str(label)

    def set_title(self, label) -> None:
        self._record("set_title", (label,), {})
        self.title = str(label)

    def _set_scale(self, axis: Axis, name: str, value, base) -> None:
        if value not in ("linear", "log"):
            raise ValueError(f"scale {value!r} is not supported")
        self._record(name, (value,), {} if base is None else {"base": base})
        axis.scale = value
        axis.base = float(base or 10)

    def set_xscale(self, value, base=None) -> None:
        self._set_scale(self.xaxis, "set_xscale", value, base)

    def set_yscale(self, value, base=None) -> None:
        self._set_scale(self.yaxis, "set_yscale", value, base)

    def grid(self, visible=True, alpha=1.0, **kwargs) -> None:
        self._record("grid", (visible,), dict(alpha=alpha, **kwargs))
        self.grid_alpha = float(alpha) if visible else None

    def legend(self, fontsize=None, **kwargs) -> None:
        self._record("legend", (), dict(fontsize=fontsize, **kwargs))
        self.legend_fontsize = float(fontsize or _FONT_PT)

    def get_legend_handles_labels(self) -> Tuple[List[Any], List[str]]:
        """Labelled artists in matplotlib's legend order: ``plot`` lines
        first, then error-bar and bar containers, each in call order."""
        labelled = [a for a in self.artists
                    if isinstance(a, (Line, Bars)) and a.label
                    and not str(a.label).startswith("_")]
        handles = [a for a in labelled
                   if isinstance(a, Line) and a.kind == "plot"] + \
            [a for a in labelled
             if not (isinstance(a, Line) and a.kind == "plot")]
        return handles, [str(h.label) for h in handles]

    def lines(self) -> List[Line]:
        return [a for a in self.artists if isinstance(a, Line)]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _finite(v: float) -> bool:
    return not (math.isnan(v) or math.isinf(v))


class _Scale:
    """Data → pixel along one axis."""

    def __init__(self, axis: Axis, lo: float, hi: float, p0: float,
                 p1: float):
        self.log = axis.scale == "log"
        self.base = axis.base
        self.lo, self.hi = self.fwd(lo), self.fwd(hi)
        self.p0, self.p1 = (p1, p0) if axis.inverted else (p0, p1)

    def fwd(self, v: float) -> float:
        return math.log(v, self.base) if self.log else v

    def __call__(self, v: float) -> Optional[float]:
        if not _finite(v) or (self.log and v <= 0):
            return None
        t = (self.fwd(v) - self.lo) / ((self.hi - self.lo) or 1.0)
        return self.p0 + t * (self.p1 - self.p0)


def _extent(ax: Axes, horizontal_axis: bool) -> List[float]:
    """Every data value the artists place along one axis (x when
    ``horizontal_axis``), bar ends and error-bar ends included."""
    out: List[float] = []
    for a in ax.artists:
        if isinstance(a, Line):
            vals = a.x if horizontal_axis else a.y
            out += vals
            if a.yerr and not horizontal_axis:
                out += [v - e for v, e in zip(a.y, a.yerr)]
                out += [v + e for v, e in zip(a.y, a.yerr)]
        elif isinstance(a, Bars):
            along = a.horizontal == horizontal_axis
            if along:
                for v, e in zip(a.values, a.err or [0.0] * len(a.values)):
                    if _finite(v):
                        out += [0.0, v - e, v + e]
            else:
                for p, v in zip(a.pos, a.values):
                    out += [p - a.thickness / 2, p + a.thickness / 2]
        elif isinstance(a, VLine) and horizontal_axis:
            out.append(a.x)
        elif isinstance(a, Annotation):
            out.append(a.xy[0] if horizontal_axis else a.xy[1])
    return [v for v in out if _finite(v)]


def _sticky_zero(ax: Axes, horizontal_axis: bool) -> bool:
    """Bars pin the axis they grow along at zero, as matplotlib's
    sticky edges do."""
    return any(isinstance(a, Bars) and a.horizontal == horizontal_axis
               for a in ax.artists)


def _limits(ax: Axes, axis: Axis, horizontal_axis: bool
            ) -> Tuple[float, float]:
    vals = _extent(ax, horizontal_axis) + list(axis.ticks or [])
    log = axis.scale == "log"
    if log:
        vals = [v for v in vals if v > 0]
    if not vals:
        return (1.0, axis.base) if log else (0.0, 1.0)
    lo, hi = min(vals), max(vals)
    f = (lambda v: math.log(v, axis.base)) if log else (lambda v: v)
    g = (lambda v: axis.base ** v) if log else (lambda v: v)
    a, b = f(lo), f(hi)
    if a == b:
        a, b = a - 0.5, b + 0.5
    span = b - a
    sticky = _sticky_zero(ax, horizontal_axis) and not log
    new_a = a - axis.margin * span
    new_b = b + axis.margin * span
    if sticky and lo >= 0.0 and a == 0.0:
        new_a = 0.0
    if sticky and hi <= 0.0 and b == 0.0:
        new_b = 0.0
    return g(new_a), g(new_b)


def _nice_step(span: float, target: int = 6) -> float:
    raw = span / max(target, 1)
    mag = 10 ** math.floor(math.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        if raw <= m * mag:
            return m * mag
    return 10 * mag


def _decimals(step: float) -> int:
    """Fewest decimals that write every multiple of ``step`` exactly."""
    for d in range(12):
        if abs(round(step, d) - step) <= 1e-9 * step:
            return d
    return 12


Ticks = List[Tuple[float, str, Optional[str]]]


def _auto_ticks(axis: Axis, lo: float, hi: float
                ) -> Tuple[Ticks, Optional[int]]:
    """(value, label, exponent) of automatic ticks inside [lo, hi], and
    the power of ten their labels are scaled by (matplotlib's offset
    text) when the values are very small or very large.  A log axis
    labels its decades as base^exponent."""
    a, b = min(lo, hi), max(lo, hi)
    if axis.scale == "log":
        base = axis.base
        k0 = math.ceil(math.log(a, base) - 1e-9)
        k1 = math.floor(math.log(b, base) + 1e-9)
        if k1 - k0 >= 1:
            stride = max(1, math.ceil((k1 - k0 + 1) / 8))
            base_txt = f"{base:g}"
            return [(base ** k, base_txt, str(k))
                    for k in range(k0, k1 + 1, stride)], None
    step = _nice_step(b - a)
    biggest = max(abs(a), abs(b))
    offset = None
    if biggest and (biggest < 1e-3 or biggest >= 1e5):
        offset = math.floor(math.log10(biggest))
    scale = 10.0 ** (offset or 0)
    decimals = _decimals(step / scale)
    out = []
    for i in range(math.ceil(a / step - 1e-9),
                   math.floor(b / step + 1e-9) + 1):
        v = i * step
        if axis.scale == "log" and v <= 0:
            continue
        out.append((v, "0" if i == 0 else f"{v / scale:.{decimals}f}",
                    None))
    return out, offset


def _ticks(axis: Axis, lo: float, hi: float
           ) -> Tuple[Ticks, Optional[int]]:
    if axis.ticks is None:
        return _auto_ticks(axis, lo, hi)
    labels = axis.ticklabels
    out = []
    for i, v in enumerate(axis.ticks):
        if labels is not None:
            text = labels[i] if i < len(labels) else ""
        else:
            text = f"{v:g}"
        out.append((v, text, None))
    return out, None


def _text_width(text: str, px: float) -> float:
    return 0.6 * px * len(text)


# ---------------------------------------------------------------------------
# the figure
# ---------------------------------------------------------------------------

class Figure:
    """One figure of one :class:`Axes`; :meth:`savefig` writes it."""

    def __init__(self, figsize: Sequence[float], ax: Axes):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.ax = ax

    def tight_layout(self) -> None:
        """Layout is computed when the figure is written."""

    def savefig(self, path: str, dpi: float = 100) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_svg(dpi))

    def to_svg(self, dpi: float = 100) -> str:
        ax = self.ax
        pt = float(dpi) / 72.0
        W, H = self.figsize[0] * dpi, self.figsize[1] * dpi
        font = _FONT_PT * pt
        pad = _PAD_PT * pt
        tick = _TICK_PT * pt

        xlo, xhi = _limits(ax, ax.xaxis, True)
        ylo, yhi = _limits(ax, ax.yaxis, False)
        xticks, xoffset = _ticks(ax.xaxis, xlo, xhi)
        yticks, yoffset = _ticks(ax.yaxis, ylo, yhi)

        # margins from what must fit around the axes
        xfont = ax.xaxis.fontsize * pt
        yfont = ax.yaxis.fontsize * pt
        xlab_w = max([_text_width(t + (e or ""), xfont)
                      for _, t, e in xticks] or [0.0])
        rot = math.radians(ax.xaxis.rotation)
        xlab_h = xlab_w * math.sin(rot) + xfont * math.cos(rot) \
            if rot else xfont
        ylab_w = max([_text_width(t + (e or ""), yfont)
                      for _, t, e in yticks] or [0.0])
        left = pad + (font + pad if ax.yaxis.label else 0) + ylab_w \
            + tick + pad
        bottom = pad + (font + pad if ax.xaxis.label else 0) + xlab_h \
            + tick + pad + (xfont + pad if xoffset is not None else 0)
        top = pad + (_TITLE_PT * pt + pad if ax.title else 0) + pad \
            + (yfont if yoffset is not None else 0)
        right = pad + (0 if rot else xlab_w / 2)
        left = min(left, 0.45 * W)
        bottom = min(bottom, 0.6 * H)
        x0, x1 = left, W - right
        y0, y1 = top, H - bottom            # y0 at the top
        sx = _Scale(ax.xaxis, xlo, xhi, x0, x1)
        sy = _Scale(ax.yaxis, ylo, yhi, y1, y0)

        out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
               f'width="{W:.0f}" height="{H:.0f}" '
               f'viewBox="0 0 {W:.2f} {H:.2f}" '
               f'font-family="DejaVu Sans, Helvetica, Arial, sans-serif">',
               f'<rect width="{W:.2f}" height="{H:.2f}" fill="#ffffff"/>',
               f'<defs><clipPath id="plot"><rect x="{x0:.2f}" '
               f'y="{y0:.2f}" width="{x1 - x0:.2f}" height="{y1 - y0:.2f}"'
               f'/></clipPath></defs>']

        if ax.grid_alpha is not None:
            out.append(f'<g stroke="#b0b0b0" stroke-width="{0.8 * pt:.2f}" '
                       f'stroke-opacity="{ax.grid_alpha:g}">')
            for v, _, _ in xticks:
                px = sx(v)
                if px is not None and x0 - 0.5 <= px <= x1 + 0.5:
                    out.append(f'<line x1="{px:.2f}" y1="{y0:.2f}" '
                               f'x2="{px:.2f}" y2="{y1:.2f}"/>')
            for v, _, _ in yticks:
                py = sy(v)
                if py is not None and y0 - 0.5 <= py <= y1 + 0.5:
                    out.append(f'<line x1="{x0:.2f}" y1="{py:.2f}" '
                               f'x2="{x1:.2f}" y2="{py:.2f}"/>')
            out.append("</g>")

        out.append('<g clip-path="url(#plot)">')
        for a in ax.artists:
            out += _draw(a, sx, sy, pt, x0, x1, y0, y1)
        out.append("</g>")

        out.append(f'<rect x="{x0:.2f}" y="{y0:.2f}" width="{x1 - x0:.2f}" '
                   f'height="{y1 - y0:.2f}" fill="none" stroke="#000000" '
                   f'stroke-width="{0.8 * pt:.2f}"/>')
        out += _tick_marks(xticks, sx, True, y1, tick, xfont, ax.xaxis, pt,
                           x0, x1)
        out += _tick_marks(yticks, sy, False, x0, tick, yfont, ax.yaxis, pt,
                           y0, y1)
        if yoffset is not None:
            out.append(_text(x0, y0 - 0.4 * yfont, "×10", yfont,
                             sup=str(yoffset)))
        if xoffset is not None:
            out.append(_text(x1, y1 + tick + xlab_h + pad + xfont, "×10",
                             xfont, anchor="end", sup=str(xoffset)))
        if ax.xaxis.label:
            out.append(_text((x0 + x1) / 2, H - pad, ax.xaxis.label, font,
                             anchor="middle"))
        if ax.yaxis.label:
            cx, cy = pad + font * 0.8, (y0 + y1) / 2
            out.append(_text(cx, cy, ax.yaxis.label, font, anchor="middle",
                             transform=f"rotate(-90 {cx:.2f} {cy:.2f})"))
        if ax.title:
            out.append(_text((x0 + x1) / 2, top - pad - 0.2 * _TITLE_PT * pt,
                             ax.title, _TITLE_PT * pt, anchor="middle"))
        if ax.legend_fontsize is not None:
            out += _legend(ax, (x0, y0, x1, y1), _occupied(ax, sx, sy),
                           ax.legend_fontsize * pt, pt)
        out.append("</svg>")
        return "\n".join(out) + "\n"


def _text(x: float, y: float, text: str, size: float,
          anchor: str = "start", baseline: Optional[str] = None,
          transform: Optional[str] = None, sup: Optional[str] = None
          ) -> str:
    attrs = [f'x="{x:.2f}"', f'y="{y:.2f}"', f'font-size="{size:.2f}"',
             f'text-anchor="{anchor}"']
    if baseline:
        attrs.append(f'dominant-baseline="{baseline}"')
    if transform:
        attrs.append(f'transform="{transform}"')
    body = escape(text)
    if sup is not None:
        body += (f'<tspan baseline-shift="super" font-size="{0.7 * size:.2f}"'
                 f'>{escape(sup)}</tspan>')
    return f"<text {' '.join(attrs)}>{body}</text>"


def _tick_marks(ticks, scale, horizontal_axis, edge, tick, size, axis,
                pt, lo, hi) -> List[str]:
    out = []
    for v, label, exp in ticks:
        p = scale(v)
        if p is None or not (min(lo, hi) - 0.5 <= p <= max(lo, hi) + 0.5):
            continue
        if horizontal_axis:
            out.append(f'<line x1="{p:.2f}" y1="{edge:.2f}" x2="{p:.2f}" '
                       f'y2="{edge + tick:.2f}" stroke="#000000" '
                       f'stroke-width="{0.8 * pt:.2f}"/>')
            y = edge + tick + 1.2 * size
            if axis.rotation:
                anchor = "end" if axis.ha == "right" else "middle"
                y = edge + tick + 0.9 * size
                out.append(_text(p, y, label, size, anchor=anchor,
                                 transform=f"rotate({-axis.rotation:g} "
                                           f"{p:.2f} {y:.2f})", sup=exp))
            else:
                out.append(_text(p, y, label, size, anchor="middle",
                                 sup=exp))
        else:
            out.append(f'<line x1="{edge - tick:.2f}" y1="{p:.2f}" '
                       f'x2="{edge:.2f}" y2="{p:.2f}" stroke="#000000" '
                       f'stroke-width="{0.8 * pt:.2f}"/>')
            out.append(_text(edge - tick - 0.4 * size, p, label, size,
                             anchor="end", baseline="central", sup=exp))
    return out


def _dash(linestyle: Optional[str], pt: float) -> str:
    if linestyle == "--":
        return f' stroke-dasharray="{3.7 * pt:.2f},{1.6 * pt:.2f}"'
    return ""


def _error_bar(cx, a, b, cap, col, pt, horizontal=False) -> List[str]:
    """A whisker from ``a`` to ``b`` at ``cx`` with caps of half-width
    ``cap`` (pixels); across when ``horizontal``."""
    w = f'stroke="{col}" stroke-width="{1.5 * pt:.2f}" class="mark errorbar"'
    if horizontal:
        out = [f'<line x1="{a:.2f}" y1="{cx:.2f}" x2="{b:.2f}" '
               f'y2="{cx:.2f}" {w}/>']
        if cap:
            out += [f'<line x1="{e:.2f}" y1="{cx - cap:.2f}" x2="{e:.2f}" '
                    f'y2="{cx + cap:.2f}" {w}/>' for e in (a, b)]
        return out
    out = [f'<line x1="{cx:.2f}" y1="{a:.2f}" x2="{cx:.2f}" y2="{b:.2f}" '
           f'{w}/>']
    if cap:
        out += [f'<line x1="{cx - cap:.2f}" y1="{e:.2f}" x2="{cx + cap:.2f}" '
                f'y2="{e:.2f}" {w}/>' for e in (a, b)]
    return out


def _marker(px, py, col, pt) -> str:
    return (f'<circle cx="{px:.2f}" cy="{py:.2f}" r="{3.0 * pt:.2f}" '
            f'fill="{col}" class="mark marker"/>')


def _draw(a, sx, sy, pt, x0, x1, y0, y1) -> List[str]:
    if isinstance(a, Line):
        label = quoteattr(str(a.label or ""))
        out = [f'<g class="series" data-label={label}>']
        pts = [(sx(x), sy(y)) for x, y in zip(a.x, a.y)]
        if a.linestyle:
            runs: List[List[Tuple[float, float]]] = [[]]
            for p in pts:
                if p[0] is None or p[1] is None:
                    runs.append([])
                else:
                    runs[-1].append(p)
            for run in runs:
                if len(run) >= 2:
                    coords = " ".join(f"{x:.2f},{y:.2f}" for x, y in run)
                    out.append(f'<polyline points="{coords}" fill="none" '
                               f'stroke="{a.color}" '
                               f'stroke-width="{1.5 * pt:.2f}"'
                               f'{_dash(a.linestyle, pt)} '
                               f'class="mark line"/>')
        if a.yerr:
            cap = a.capsize * pt
            for (x, y), e in zip(zip(a.x, a.y), a.yerr):
                px, lo, hi = sx(x), sy(y - e), sy(y + e)
                if e and px is not None and lo is not None and \
                        hi is not None:
                    out += _error_bar(px, lo, hi, cap, a.color, pt)
        if a.marker:
            out += [_marker(px, py, a.color, pt)
                    for px, py in pts if px is not None and py is not None]
        out.append("</g>")
        return out
    if isinstance(a, Bars):
        label = quoteattr(str(a.label or ""))
        out = [f'<g class="series" data-label={label} '
               f'fill-opacity="{a.alpha:g}">']
        along, across = (sx, sy) if a.horizontal else (sy, sx)
        errs = a.err or [0.0] * len(a.values)
        for p, v, col, e in zip(a.pos, a.values, a.colors, errs):
            if not _finite(v):
                continue
            c0 = across(p - a.thickness / 2)
            c1 = across(p + a.thickness / 2)
            base = along(0.0)
            if base is None:                # log axis: from its edge
                base = x0 if a.horizontal else y1
            end = along(v)
            if c0 is None or c1 is None or end is None:
                continue
            if a.horizontal:
                x, w = min(base, end), abs(end - base)
                y, h = min(c0, c1), abs(c1 - c0)
            else:
                x, w = min(c0, c1), abs(c1 - c0)
                y, h = min(base, end), abs(end - base)
            out.append(f'<rect x="{x:.2f}" y="{y:.2f}" width="{w:.2f}" '
                       f'height="{h:.2f}" fill="{col}" class="mark bar"/>')
            if e:
                lo, hi = along(v - e), along(v + e)
                center = (c0 + c1) / 2
                if lo is not None and hi is not None:
                    out += _error_bar(center, lo, hi, a.capsize * pt,
                                      "#000000", pt, a.horizontal)
        out.append("</g>")
        return out
    if isinstance(a, VLine):
        px = sx(a.x)
        if px is None:
            return []
        return [f'<line x1="{px:.2f}" y1="{y0:.2f}" x2="{px:.2f}" '
                f'y2="{y1:.2f}" stroke="{a.color}" '
                f'stroke-width="{a.linewidth * pt:.2f}"/>']
    if isinstance(a, Annotation):
        px, py = sx(a.xy[0]), sy(a.xy[1])
        if px is None or py is None:
            return []
        baseline = {"center": "central", "top": "hanging",
                    "bottom": "text-after-edge"}.get(a.va)
        return [_text(px + a.offset[0] * pt, py - a.offset[1] * pt, a.text,
                      a.fontsize * pt, baseline=baseline)]
    raise TypeError(f"cannot draw {type(a).__name__}")


def _occupied(ax: Axes, sx: _Scale, sy: _Scale
              ) -> List[Tuple[float, float]]:
    """Pixels the data covers: line vertices and points along their
    segments, a grid of points over every bar, annotation anchors."""
    pts: List[Tuple[float, float]] = []
    for a in ax.artists:
        if isinstance(a, Line):
            xy = [(sx(x), sy(y)) for x, y in zip(a.x, a.y)]
            xy = [p for p in xy if p[0] is not None and p[1] is not None]
            pts += xy
            if a.linestyle:
                for (xa, ya), (xb, yb) in zip(xy, xy[1:]):
                    pts += [(xa + (xb - xa) * t / 8, ya + (yb - ya) * t / 8)
                            for t in range(1, 8)]
        elif isinstance(a, Bars):
            along, across = (sx, sy) if a.horizontal else (sy, sx)
            for p, v in zip(a.pos, a.values):
                ends = [along(0.0), along(v)]
                sides = [across(p - a.thickness / 2),
                         across(p + a.thickness / 2)]
                if None in ends or None in sides:
                    continue
                for i in range(5):
                    e = ends[0] + (ends[1] - ends[0]) * i / 4
                    for j in range(3):
                        c = sides[0] + (sides[1] - sides[0]) * j / 2
                        pts.append((e, c) if a.horizontal else (c, e))
        elif isinstance(a, Annotation):
            p = (sx(a.xy[0]), sy(a.xy[1]))
            if None not in p:
                pts.append(p)
    return pts


#: matplotlib's ``loc="best"`` candidates in its order of preference, as
#: (left, top) fractions of the free room: upper right, upper left,
#: lower left, lower right, right, center left, lower center, upper
#: center, center.
_LEGEND_SPOTS = ((1, 0), (0, 0), (0, 1), (1, 1), (1, 0.5), (0, 0.5),
                 (0.5, 1), (0.5, 0), (0.5, 0.5))


def _legend(ax: Axes, frame: Tuple[float, float, float, float],
            occupied: List[Tuple[float, float]], size: float, pt: float
            ) -> List[str]:
    """The legend, where it covers the fewest data points (matplotlib's
    ``loc="best"``: the first of its spots on a tie)."""
    handles, labels = ax.get_legend_handles_labels()
    if not handles:
        return []
    x0, y0, x1, y1 = frame
    row = 1.4 * size
    sample = 2.0 * size
    width = sample + 0.8 * size + max(_text_width(t, size) for t in labels) \
        + 0.8 * size
    height = row * len(labels) + 0.6 * size
    gap = 0.5 * size

    def box(fx: float, fy: float) -> Tuple[float, float]:
        left = x0 + gap + fx * (x1 - x0 - width - 2 * gap)
        top = y0 + gap + fy * (y1 - y0 - height - 2 * gap)
        return left, top

    def covered(spot: Tuple[float, float]) -> int:
        left, top = box(*spot)
        return sum(1 for px, py in occupied
                   if left <= px <= left + width and top <= py <= top + height)

    left, top = box(*min(_LEGEND_SPOTS, key=covered))
    out = [f'<g class="legend"><rect x="{left:.2f}" y="{top:.2f}" '
           f'width="{width:.2f}" height="{height:.2f}" fill="#ffffff" '
           f'fill-opacity="0.8" stroke="#cccccc" '
           f'stroke-width="{0.8 * pt:.2f}" rx="{2 * pt:.2f}"/>']
    for i, (h, label) in enumerate(zip(handles, labels)):
        cy = top + 0.3 * size + row * (i + 0.5)
        sx0 = left + 0.4 * size
        if isinstance(h, Bars):
            out.append(f'<rect x="{sx0:.2f}" y="{cy - 0.35 * size:.2f}" '
                       f'width="{sample:.2f}" height="{0.7 * size:.2f}" '
                       f'fill="{h.colors[0] if h.colors else CYCLE[0]}" '
                       f'fill-opacity="{h.alpha:g}"/>')
        else:
            if h.linestyle:
                out.append(f'<line x1="{sx0:.2f}" y1="{cy:.2f}" '
                           f'x2="{sx0 + sample:.2f}" y2="{cy:.2f}" '
                           f'stroke="{h.color}" '
                           f'stroke-width="{1.5 * pt:.2f}"'
                           f'{_dash(h.linestyle, pt)}/>')
            if h.marker:
                out.append(f'<circle cx="{sx0 + sample / 2:.2f}" '
                           f'cy="{cy:.2f}" r="{3.0 * pt:.2f}" '
                           f'fill="{h.color}"/>')
        out.append(_text(sx0 + sample + 0.4 * size, cy, label, size,
                         baseline="central"))
    out.append("</g>")
    return out


def subplots(figsize: Sequence[float] = (7, 4.5)) -> Tuple[Figure, Axes]:
    """A figure of ``figsize`` inches holding one empty :class:`Axes`."""
    ax = Axes()
    return Figure(figsize, ax), ax

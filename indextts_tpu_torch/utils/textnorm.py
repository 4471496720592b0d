"""Text normalisation front-end.

Behavioural rebuild of the reference TextNormalizer
(indextts/utils/front.py:11-218): CJK/English detection, punctuation
mapping, pinyin-tone save/restore, CJK-name save/restore, English
contraction expansion.  The reference delegates number/date expansion to
WeTextProcessing ("tn") / wetext; neither ships in this image, so a
lightweight built-in number normaliser is used as fallback and the external
normalisers are picked up automatically when importable.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple


class _BuiltinNormalizer:
    """Minimal fallback for WeTextProcessing: expands digit runs so that the
    tokenizer never sees raw digits (the BPE vocab has no digit pieces)."""

    _ZH_DIGITS = "零一二三四五六七八九"
    _ZH_UNITS = ["", "十", "百", "千"]
    _ZH_GROUPS = ["", "萬", "億", "兆"]
    _EN_ONES = [
        "zero", "one", "two", "three", "four", "five", "six", "seven",
        "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
        "fifteen", "sixteen", "seventeen", "eighteen", "nineteen",
    ]
    _EN_TENS = [
        "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
        "eighty", "ninety",
    ]

    def __init__(self, lang: str):
        self.lang = lang

    # -- Chinese ----------------------------------------------------------
    def _zh_four(self, n: int) -> str:
        # 0 <= n < 10000
        s = ""
        digits = [int(c) for c in str(n)]
        L = len(digits)
        for i, d in enumerate(digits):
            unit = self._ZH_UNITS[L - 1 - i]
            if d == 0:
                if s and not s.endswith("零") and any(digits[i + 1 :]):
                    s += "零"
            else:
                s += self._ZH_DIGITS[d] + unit
        # 一十X -> 十X
        if s.startswith("一十"):
            s = s[1:]
        return s or "零"

    def _zh_int(self, n: int) -> str:
        if n == 0:
            return "零"
        groups = []
        while n > 0:
            groups.append(n % 10000)
            n //= 10000
        parts = []
        for i in reversed(range(len(groups))):
            g = groups[i]
            if g:
                parts.append(self._zh_four(g) + self._ZH_GROUPS[i])
            elif parts and not parts[-1].endswith("零"):
                parts.append("零")
        s = "".join(parts).rstrip("零")
        return s or "零"

    def _zh_number(self, text: str) -> str:
        if "." in text:
            a, b = text.split(".", 1)
            frac = "".join(self._ZH_DIGITS[int(c)] for c in b if c.isdigit())
            return self._zh_int(int(a or 0)) + "點" + frac
        return self._zh_int(int(text))

    def _zh_digit_string(self, text: str) -> str:
        return "".join(self._ZH_DIGITS[int(c)] for c in text if c.isdigit())

    # -- English ----------------------------------------------------------
    def _en_below_thousand(self, n: int) -> str:
        parts = []
        if n >= 100:
            parts.append(self._EN_ONES[n // 100] + " hundred")
            n %= 100
            if n:
                parts.append("and")
        if n >= 20:
            t = self._EN_TENS[n // 10]
            if n % 10:
                t += " " + self._EN_ONES[n % 10]
            parts.append(t)
        elif n > 0 or not parts:
            parts.append(self._EN_ONES[n])
        return " ".join(parts)

    def _en_int(self, n: int) -> str:
        if n == 0:
            return "zero"
        scales = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]
        parts = []
        for value, name in scales:
            if n >= value:
                parts.append(self._en_below_thousand(n // value) + " " + name)
                n %= value
        if n:
            parts.append(self._en_below_thousand(n))
        return " ".join(parts)

    def _en_number(self, text: str) -> str:
        if "." in text:
            a, b = text.split(".", 1)
            frac = " ".join(self._EN_ONES[int(c)] for c in b if c.isdigit())
            return self._en_int(int(a or 0)) + " point " + frac
        return self._en_int(int(text))

    # ordinal word endings (en)
    _EN_ORDINAL = {
        "one": "first", "two": "second", "three": "third", "five": "fifth",
        "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
    }

    def _en_ordinal(self, n: int) -> str:
        words = self._en_int(n).split()
        last = words[-1]
        if last in self._EN_ORDINAL:
            words[-1] = self._EN_ORDINAL[last]
        elif last.endswith("y"):
            words[-1] = last[:-1] + "ieth"
        else:
            words[-1] = last + "th"
        return " ".join(words)

    # -- rule passes --------------------------------------------------------

    def _pass_zh(self, text: str) -> str:
        num = self._zh_number
        dig = self._zh_digit_string

        # dates: 2030/1/2 → 二零三零年一月二日; 2002年 → 二零零二年 (years
        # digit-wise, WeTextProcessing convention); 01月11日 → 一月十一日
        text = re.sub(
            r"(\d{4})\s*[/-](\d{1,2})\s*[/-](\d{1,2})(?!\d)",
            lambda m: f"{dig(m.group(1))}年{num(m.group(2).lstrip('0') or '0')}月"
                      f"{num(m.group(3).lstrip('0') or '0')}日", text)
        text = re.sub(r"(\d{2,4})\s*年",
                      lambda m: dig(m.group(1)) + "年", text)
        text = re.sub(r"(\d{1,2})\s*月",
                      lambda m: num(m.group(1).lstrip("0") or "0") + "月", text)
        text = re.sub(r"(\d{1,2})\s*([日號])",
                      lambda m: num(m.group(1).lstrip("0") or "0") + m.group(2),
                      text)
        # times: 20:00 → 二十點; 20:30:05 → 二十點三十分零五秒
        def ftime(m):
            h, mi, s = m.group(1), m.group(2), m.group(3)
            # hour 2 reads 兩點, never 二點 (WeTextProcessing time verbalizer
            # / standard Mandarin); only the bare hour — 12:00 stays 十二點
            out = ("兩" if h.lstrip("0") == "2" else
                   num(h.lstrip("0") or "0")) + "點"
            if mi != "00":
                out += num(mi.lstrip("0") or "0") + "分"
            if s and s != "00":
                out += num(s.lstrip("0") or "0") + "秒"
            return out
        text = re.sub(r"(?<![\d:])(\d{1,2}):(\d{2})(?::(\d{2}))?(?![\d:])",
                      ftime, text)
        # sports scores (after times, which consume :MM two-digit minutes):
        # 3:2 → 三比二 (tn sport tagger)
        text = re.sub(r"(?<![\d:])(\d{1,2}):(\d{1,2})(?![\d:])",
                      lambda m: num(m.group(1)) + "比" + num(m.group(2)), text)
        # fractions: 2/3 → 三分之二 (denominator read first; dates with two
        # separators were consumed above, unit slashes have no flanking digits)
        text = re.sub(r"(?<![\d./])(\d{1,4})/(\d{1,4})(?![\d./])",
                      lambda m: num(m.group(2)) + "分之" + num(m.group(1)),
                      text)
        # year ranges read digit-wise: 2010-2020 → 二零一零到二零二零
        def fyrange(m):
            a, b = m.group(1), m.group(2)
            return (dig(a) + "到" + dig(b)) if int(a) <= int(b) else m.group(0)
        text = re.sub(r"(?<![\d.-])(\d{4})\s*[-~～—]\s*(\d{4})(?![\d.-])",
                      fyrange, text)
        # phone-like hyphenated digit groups read digit-wise.  Requires ≥2
        # separators (135-4567-8900) or an area-code form (0571-88888888):
        # a SINGLE-hyphen pair like 100-500 is a value range in prose, and
        # the old 1-hyphen match consumed "100-500%" before the range rules
        # could run, orphaning the %
        text = re.sub(
            r"(?<!\d)(\d{3,4}(?:-\d{3,4}){2,3})(?!\d)",
            lambda m: dig(m.group(1).replace("-", "")), text)
        text = re.sub(
            r"(?<!\d)(0\d{2,3}-\d{7,8})(?!\d)",
            lambda m: dig(m.group(1).replace("-", "")), text)
        # units glued to numbers (tn's measure tagger, common cases) —
        # shared by the range rules below and the plain-unit rule later
        units = [("km/h", "公里每小時"), ("m/s", "米每秒"), ("km", "公里"),
                 ("kg", "公斤"), ("cm", "釐米"), ("mm", "毫米"), ("ml", "毫升"),
                 ("kw", "千瓦"), ("°c", "攝氏度"), ("℃", "攝氏度"),
                 ("g", "克"), ("m", "米"), ("l", "升"), ("h", "小時"),
                 ("s", "秒")]
        unit_pat = r"km/h|m/s|km|kg|cm|mm|ml|kw|°[Cc]|℃|[gmlhs]"
        def unit_word(u):
            u = u.lower()
            for key, word in units:
                if u == key:
                    return word
            return None
        # percent ranges: 3-5% → 百分之三到百分之五 (before the plain
        # percent rule, which would otherwise leave the range's first half)
        text = re.sub(
            r"(?<![\d.-])(\d+(?:\.\d+)?)\s*[-~～—]\s*(\d+(?:\.\d+)?)\s*%",
            lambda m: "百分之" + num(m.group(1)) + "到百分之" + num(m.group(2)),
            text)
        # unit ranges: 3-5km → 三到五公里 (before the plain range rule,
        # which would strip the digits the unit rule keys on)
        def frange_unit(m):
            a, b, u = m.group(1), m.group(2), m.group(3)
            word = unit_word(u)
            if word is not None and float(a) <= float(b):
                return num(a) + "到" + num(b) + word
            return m.group(0)
        text = re.sub(
            r"(?<![\d.-])(\d+(?:\.\d+)?)\s*[-~～—]\s*(\d+(?:\.\d+)?)\s*"
            r"(" + unit_pat + r")(?![a-zA-Z])",
            frange_unit, text)
        # value ranges: 3-5個 → 三到五個 (ascending pairs only; anything
        # else reads as separate numbers through the fallback)
        def frange(m):
            a, b = m.group(1), m.group(2)
            if float(a) <= float(b):
                return num(a) + "到" + num(b)
            return m.group(0)
        text = re.sub(
            r"(?<![\d.-])(\d+(?:\.\d+)?)\s*[-~～—]\s*(\d+(?:\.\d+)?)(?![\d.-])",
            frange, text)
        # percent is a prefix word: 2.5% → 百分之二點五
        text = re.sub(r"(\d+(?:,\d{3})*(?:\.\d+)?)\s*%",
                      lambda m: "百分之" + num(m.group(1).replace(",", "")), text)
        # currency: ¥12999 → 一萬二千九百九十九元
        text = re.sub(r"[¥￥]\s*(\d+(?:,\d{3})*(?:\.\d+)?)",
                      lambda m: num(m.group(1).replace(",", "")) + "元", text)
        # counts with a trailing +: 點贊3000+ → 點贊三千多
        text = re.sub(r"(\d+(?:,\d{3})*)\s*\+",
                      lambda m: num(m.group(1).replace(",", "")) + "多", text)
        # plain number+unit (the units/unit_word table is hoisted above the
        # range rules, which share it)
        def funit(m):
            sign, n = m.group(1), m.group(2)
            word = unit_word(m.group(3))
            if word is not None:
                body = num(n.replace(",", "")) + word
                if sign:
                    # temperatures read 零下, other quantities 負
                    return ("零下" if "攝氏" in word else "負") + body
                return body
            return m.group(0)
        text = re.sub(r"(-?)(\d+(?:,\d{3})*(?:\.\d+)?)\s*"
                      r"(" + unit_pat + r")(?![a-zA-Z])",
                      funit, text)
        # bare negative numbers: -5 → 負五 (ranges/phones/units consumed
        # their hyphens above; a digit-adjacent hyphen is never a sign here)
        text = re.sub(r"(?<![0-9a-zA-Z])-(\d+(?:\.\d+)?)",
                      lambda m: "負" + num(m.group(1)), text)
        return text

    def _pass_en(self, text: str) -> str:
        # fractions: 2/3 → two thirds; 1/2 → one half; 3/4 → three quarters
        def ffrac(m):
            a, b = int(m.group(1)), int(m.group(2))
            if b == 2:
                word = "half" if a == 1 else "halves"
            elif b == 4:
                word = "quarter" if a == 1 else "quarters"
            else:
                word = self._en_ordinal(b) + ("" if a == 1 else "s")
            return f"{self._en_int(a)} {word}"
        text = re.sub(r"(?<![\d./])(\d{1,3})/(\d{1,3})(?![\d./])", ffrac, text)
        # times: 8:00 → eight o'clock; 8:30 → eight thirty
        def ftime(m):
            h, mi = int(m.group(1)), m.group(2)
            if mi == "00":
                return f"{self._en_int(h)} o'clock"
            if mi.startswith("0"):
                return f"{self._en_int(h)} oh {self._en_int(int(mi))}"
            return f"{self._en_int(h)} {self._en_int(int(mi))}"
        text = re.sub(r"(?<![\d:])(\d{1,2}):(\d{2})(?![\d:])", ftime, text)
        # measure units glued to numbers (tn's en measure tagger analogue).
        # Case-sensitive single letters so "5G" (network) and "1960s"
        # (decade) are left alone; bare "s" is excluded for the same reason.
        en_units = [("km/h", "kilometer per hour", "kilometers per hour"),
                    ("m/s", "meter per second", "meters per second"),
                    ("km", "kilometer", "kilometers"),
                    ("kg", "kilogram", "kilograms"),
                    ("cm", "centimeter", "centimeters"),
                    ("mm", "millimeter", "millimeters"),
                    ("ml", "milliliter", "milliliters"),
                    ("kw", "kilowatt", "kilowatts"),
                    ("kW", "kilowatt", "kilowatts"),
                    ("°C", "degree Celsius", "degrees Celsius"),
                    ("°c", "degree Celsius", "degrees Celsius"),
                    ("℃", "degree Celsius", "degrees Celsius"),
                    ("g", "gram", "grams"),
                    ("m", "meter", "meters"),
                    ("l", "liter", "liters"),
                    ("h", "hour", "hours")]
        en_unit_pat = r"km/h|m/s|km|kg|cm|mm|ml|kw|kW|°[Cc]|℃|[gmlh]"
        def en_unit_word(u, plural):
            for key, sing, plur in en_units:
                if u == key:
                    return plur if plural else sing
            return None
        # unit ranges first (3-5km → three to five kilometers), then plain
        # number+unit; both before the generic range/number rules, which
        # would strip the digits the unit match keys on
        def funit_range(m):
            a, b, u = m.group(1), m.group(2), m.group(3)
            word = en_unit_word(u, True)
            if word is not None and float(a) <= float(b):
                return (f"{self._en_number(a)} to "
                        f"{self._en_number(b)} {word}")
            return m.group(0)
        text = re.sub(
            r"(?<![\d.-])(\d+(?:\.\d+)?)\s*[-~～—]\s*(\d+(?:\.\d+)?)\s*"
            r"(" + en_unit_pat + r")(?![a-zA-Z])",
            funit_range, text)
        def funit(m):
            sign, n, u = m.group(1), m.group(2).replace(",", ""), m.group(3)
            word = en_unit_word(u, float(n) != 1)
            if word is None:
                return m.group(0)
            out = f"{self._en_number(n)} {word}"
            return ("minus " + out) if sign else out
        text = re.sub(
            r"(-?)(\d+(?:,\d{3})*(?:\.\d+)?)\s*"
            r"(" + en_unit_pat + r")(?![a-zA-Z])",
            funit, text)
        # value ranges: pages 3-5 → pages three to five (ascending only;
        # after times so 9:00-10:30 can't bleed across the colon groups)
        def frange(m):
            a, b = m.group(1), m.group(2)
            if float(a) <= float(b):
                return f"{self._en_number(a)} to {self._en_number(b)}"
            return m.group(0)
        text = re.sub(
            r"(?<![\d.-])(\d+(?:\.\d+)?)\s*[-~～—]\s*(\d+(?:\.\d+)?)(?![\d.-])",
            frange, text)
        # bare negative numbers: -5 → minus five
        text = re.sub(
            r"(?<![0-9a-zA-Z])-(\d+(?:\.\d+)?)",
            lambda m: "minus " + self._en_number(m.group(1)), text)
        # ordinals: 1st, 22nd, 103rd …
        text = re.sub(r"(\d+)(st|nd|rd|th)\b",
                      lambda m: self._en_ordinal(int(m.group(1))), text,
                      flags=re.IGNORECASE)
        # currency: $12.5 → twelve point five dollars; $1 → one dollar
        def fmoney(m):
            raw = m.group(1).replace(",", "")
            unit = "dollar" if raw == "1" else "dollars"
            return f"{self._en_number(raw)} {unit}"
        text = re.sub(r"\$\s*(\d+(?:,\d{3})*(?:\.\d+)?)", fmoney, text)
        # decades: 1960s → nineteen sixties, 2020s → twenty twenties
        decades = {"20": "twenties", "30": "thirties", "40": "forties",
                   "50": "fifties", "60": "sixties", "70": "seventies",
                   "80": "eighties", "90": "nineties"}
        text = re.sub(
            r"\b(1[1-9]|20)([2-9]0)s\b",
            lambda m: f"{self._en_int(int(m.group(1)))} {decades[m.group(2)]}",
            text)
        # split residual digit-letter glue ("5G" → "5 G" → "five G") so the
        # number fallback can't weld words ("fiveG")
        text = re.sub(r"(\d)(?=[A-Za-z])", r"\1 ", text)
        return text

    def normalize(self, text: str) -> str:
        text = self._pass_zh(text) if self.lang == "zh" else self._pass_en(text)

        def repl(m: "re.Match[str]") -> str:
            raw = m.group(0).replace(",", "")
            try:
                if self.lang == "zh":
                    # IDs/serials read digit-wise: long digit strings and
                    # anything with a leading zero (007, 0571…)
                    if "." not in raw and (len(raw) > 8 or
                                           (raw.startswith("0") and len(raw) > 1)):
                        return self._zh_digit_string(raw)
                    return self._zh_number(raw)
                if "." not in raw and (len(raw) > 9 or
                                       (raw.startswith("0") and len(raw) > 1)):
                    return " ".join(self._EN_ONES[int(c)] for c in raw)
                return self._en_number(raw)
            except (ValueError, IndexError):
                return m.group(0)

        text = re.sub(r"\d+(?:,\d{3})*(?:\.\d+)?", repl, text)
        if self.lang == "en":
            text = re.sub(r"%", " percent", text)
            text = re.sub(r"\$", " dollars ", text)
        else:
            text = re.sub(r"%", "百分之", text)
            text = self._liang_pass(text)
        return text

    # quantity 2 reads 兩 before a measure word (WeTextProcessing quantifier
    # verbalizer / standard Mandarin): 2個 → 兩個, 2000人 → 兩千人.  ONLY a
    # standalone 2 — 十二個 / 二十二張 / 一百零二件 keep 二 (guarded by the
    # numeral lookbehind), as do ordinals (第二名), dates (二月二日), years
    # (digit-wise 二零零二年), decimals (二點五), and pure cardinals with no
    # measure word (2000 → 二千).
    _LIANG_MEASURES = (
        "個月|小時|分鐘|公里|公斤|毫升|平方|個|位|隻|條|張|本|輛|件|瓶|"
        "杯|歲|塊|斤|次|碗|年|天|週|倍|間|家|顆|粒|台|部|座|篇|首|棵|匹|頭|"
        "米|克|噸|升|秒|名|隊|組|層|樓|步|句|段|場|排|門|人")
    _NUMERAL_GUARD = "零一二三四五六七八九十百千萬億點第"

    def _liang_pass(self, text: str) -> str:
        text = re.sub(
            r"(?<![" + self._NUMERAL_GUARD + r"])二(?=(?:"
            + self._LIANG_MEASURES + r"))", "兩", text)
        # bare hour-of-day 2點 (no colon, so ftime never saw it) reads 兩點
        # too — but a DECIMAL 二點五 must stay, so 點+numeral only converts
        # with an explicit 分 suffix (2點10分 → 兩點十分 vs 2.5 → 二點五)
        text = re.sub(
            r"(?<![" + self._NUMERAL_GUARD + r"])二(?=點(?:[^零一二三四五六七八九]|$"
            r"|[零一二三四五六七八九十]{1,3}分))", "兩", text)
        # 2 at a 千/萬/億 head position with a measure word after the unit
        # chain: 兩千人 / 兩萬元 (a bare cardinal 2000 stays 二千)
        return re.sub(
            r"(?<![" + self._NUMERAL_GUARD + r"])二(?=[千萬億]"
            r"[零一二三四五六七八九十百千萬億]*(?:" + self._LIANG_MEASURES
            + r"|元|多))", "兩", text)


class TextNormalizer:
    """reference: indextts/utils/front.py:11-218."""

    PINYIN_TONE_PATTERN = (
        r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
        r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
        r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])"
    )
    NAME_PATTERN = r"[一-鿿]+(?:[-·—][一-鿿]+){1,2}"
    ENGLISH_CONTRACTION_PATTERN = (
        r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"
    )

    def __init__(self):
        self.zh_normalizer = None
        self.en_normalizer = None
        self.char_rep_map = {
            "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
            "？": "?", "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…",
            "，，，": "…", "……": "…", "“": "'", "”": "'", '"': "'", "‘": "'",
            "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'",
            "》": "'", "【": "'", "】": "'", "[": "'", "]": "'", "—": "-",
            "～": "-", "~": "-", "「": "'", "」": "'", ":": ",",
        }
        self.zh_char_rep_map = {"$": ".", **self.char_rep_map}

    def match_email(self, email: str) -> bool:
        return re.match(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$", email) is not None

    def use_chinese(self, s: str) -> bool:
        has_chinese = bool(re.search(r"[一-鿿]", s))
        has_alpha = bool(re.search(r"[a-zA-Z]", s))
        if has_chinese or not has_alpha or self.match_email(s):
            return True
        return bool(re.search(self.PINYIN_TONE_PATTERN, s, re.IGNORECASE))

    def load(self):
        """Prefer WeTextProcessing/wetext when importable; otherwise use the
        built-in fallback normaliser."""
        if self.zh_normalizer is not None and self.en_normalizer is not None:
            return
        try:  # pragma: no cover - external dep not in test image
            from tn.chinese.normalizer import Normalizer as NormalizerZh
            from tn.english.normalizer import Normalizer as NormalizerEn

            self.zh_normalizer = NormalizerZh(
                remove_interjections=False, remove_erhua=False, overwrite_cache=False
            )
            self.en_normalizer = NormalizerEn(overwrite_cache=False)
            return
        except Exception:
            pass
        try:  # pragma: no cover
            from wetext import Normalizer

            self.zh_normalizer = Normalizer(remove_erhua=False, lang="zh", operator="tn")
            self.en_normalizer = Normalizer(lang="en", operator="tn")
            return
        except Exception:
            pass
        self.zh_normalizer = _BuiltinNormalizer("zh")
        self.en_normalizer = _BuiltinNormalizer("en")

    def normalize(self, text: str) -> str:
        if not self.zh_normalizer or not self.en_normalizer:
            self.load()
        if self.use_chinese(text):
            text = re.sub(
                self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text, flags=re.IGNORECASE
            )
            replaced_text, pinyin_list = self.save_pinyin_tones(text.rstrip())
            replaced_text, name_list = self.save_names(replaced_text)
            try:
                result = self.zh_normalizer.normalize(replaced_text)
            except Exception:
                result = replaced_text
            result = self.restore_names(result, name_list)
            result = self.restore_pinyin_tones(result, pinyin_list)
            pattern = re.compile("|".join(re.escape(p) for p in self.zh_char_rep_map))
            result = pattern.sub(lambda x: self.zh_char_rep_map[x.group()], result)
        else:
            text = re.sub(
                self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text, flags=re.IGNORECASE
            )
            try:
                result = self.en_normalizer.normalize(text)
            except Exception:
                result = text
            pattern = re.compile("|".join(re.escape(p) for p in self.char_rep_map))
            result = pattern.sub(lambda x: self.char_rep_map[x.group()], result)
        return result

    def correct_pinyin(self, pinyin: str) -> str:
        """jqx + u/ü → v (reference: front.py:148-158)."""
        if pinyin[0] not in "jqxJQX":
            return pinyin
        pinyin = re.sub(
            r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>", pinyin, flags=re.IGNORECASE
        )
        return pinyin.upper()

    def save_names(self, text: str) -> Tuple[str, Optional[List[str]]]:
        name_list = re.findall(re.compile(self.NAME_PATTERN, re.IGNORECASE), text)
        if not name_list:
            return text, None
        name_list = list(set("".join(n) for n in name_list))
        for i, name in enumerate(name_list):
            text = text.replace(name, f"<n_{chr(ord('a') + i)}>")
        return text, name_list

    def restore_names(self, text: str, name_list: Optional[List[str]]) -> str:
        if not name_list:
            return text
        for i, name in enumerate(name_list):
            text = text.replace(f"<n_{chr(ord('a') + i)}>", name)
        return text

    def save_pinyin_tones(self, text: str) -> Tuple[str, Optional[List[str]]]:
        pinyin_list = re.findall(
            re.compile(self.PINYIN_TONE_PATTERN, re.IGNORECASE), text
        )
        if not pinyin_list:
            return text, None
        pinyin_list = list(set("".join(p) for p in pinyin_list))
        for i, pinyin in enumerate(pinyin_list):
            text = text.replace(pinyin, f"<pinyin_{chr(ord('a') + i)}>")
        return text, pinyin_list

    def restore_pinyin_tones(self, text: str, pinyin_list: Optional[List[str]]) -> str:
        if not pinyin_list:
            return text
        for i, pinyin in enumerate(pinyin_list):
            text = text.replace(f"<pinyin_{chr(ord('a') + i)}>", self.correct_pinyin(pinyin))
        return text


def tokenize_by_CJK_char(line: str, do_upper_case: bool = True) -> str:
    """Split CJK chars apart, upper-case latin (reference:
    indextts/utils/common.py:39-59)."""
    pattern = (
        "([\u1100-\u11ff\u2e80-\ua4cf\ua840-\uD7AF\uF900-\uFAFF"
        "\uFE30-\uFE4F\uFF65-\uFFDC\U00020000-\U0002FFFF])"
    )
    chars = re.split(pattern, line.strip())
    return " ".join(
        w.strip().upper() if do_upper_case else w.strip() for w in chars if w.strip()
    )


def de_tokenized_by_CJK_char(line: str, do_lower_case: bool = False) -> str:
    """Inverse of tokenize_by_CJK_char (reference: common.py:62-88)."""
    english_word_pattern = re.compile(r"([A-Z]+(?:[\s-][A-Z-]+)*)", re.IGNORECASE)
    english_sents = english_word_pattern.findall(line)
    for i, sent in enumerate(english_sents):
        line = line.replace(sent, f"<sent_{i}>")
    words = line.split()
    placeholder = re.compile(r"^.*?(<sent_(\d+)>)")
    for i in range(len(words)):
        m = placeholder.match(words[i])
        if m:
            idx = int(m.group(2))
            words[i] = words[i].replace(m.group(1), english_sents[idx])
            if do_lower_case:
                words[i] = words[i].lower()
    return "".join(words)

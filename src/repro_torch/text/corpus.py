"""Synthetic Turkish-tweet corpus with planted polarity signal.

The paper's corpus (3.4M tweets about 108 public + 66 private Turkish
universities via the 2014 Twitter Streaming API) is not available
offline, so experiments run on a synthetic corpus with the same
*structure*: university-entity mentions, Tablo 4 stopwords as noise,
class-conditional sentiment lexicons, and Tablo 5 class proportions.
DESIGN.md §6 records this honesty note; EXPERIMENTS.md reports the
paper's absolute numbers next to ours.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.text.stopwords import TURKISH_STOPWORDS

# A few dozen real names; the remainder are synthesized to reach the
# paper's 108 public + 66 private.
_PUBLIC_SEED = [
    "istanbul üniversitesi", "odtü", "boğaziçi üniversitesi", "itü",
    "ankara üniversitesi", "ege üniversitesi", "hacettepe üniversitesi",
    "marmara üniversitesi", "gazi üniversitesi", "dokuz eylül üniversitesi",
    "yıldız teknik üniversitesi", "anadolu üniversitesi",
    "akdeniz üniversitesi", "selçuk üniversitesi", "erciyes üniversitesi",
    "karadeniz teknik üniversitesi", "çukurova üniversitesi",
    "uludağ üniversitesi", "atatürk üniversitesi", "fırat üniversitesi",
]
_PRIVATE_SEED = [
    "bilkent üniversitesi", "koç üniversitesi", "sabancı üniversitesi",
    "başkent üniversitesi", "yeditepe üniversitesi", "bahçeşehir üniversitesi",
    "istanbul bilgi üniversitesi", "kadir has üniversitesi",
    "özyeğin üniversitesi", "tobb etü", "atılım üniversitesi",
    "çankaya üniversitesi", "işık üniversitesi", "maltepe üniversitesi",
]

POSITIVE_LEXICON = [
    "güzel", "harika", "başarılı", "mutlu", "teşekkürler", "mükemmel",
    "sevindim", "iyi", "kaliteli", "gurur", "muhteşem", "tebrikler",
    "kazandım", "süper", "keyifli", "memnun", "başarı", "sevgi",
]
NEGATIVE_LEXICON = [
    "kötü", "berbat", "rezalet", "üzgün", "şikayet", "sorun", "yetersiz",
    "mağdur", "zam", "kalitesiz", "saçma", "bıktım", "korkunç", "kaybettim",
    "sinir", "perişan", "skandal", "başarısız",
]
NEUTRAL_LEXICON = [
    "kayıt", "duyuru", "sınav", "ders", "kampüs", "etkinlik", "konferans",
    "bölüm", "öğrenci", "akademik", "yemekhane", "kütüphane", "tercih",
    "seminer", "yurt", "dönem", "hoca", "not",
]
_STOPWORD_LIST = sorted(TURKISH_STOPWORDS)

CLASS_NEG, CLASS_NEU, CLASS_POS = -1, 0, 1


class Corpus(NamedTuple):
    texts: List[str]
    labels: np.ndarray        # int in {-1, 0, +1}
    universities: np.ndarray  # index into .university_names
    university_names: List[str]
    university_kinds: np.ndarray  # 0 = public (devlet), 1 = private (vakıf)


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    num_messages: int = 4096
    classes: Tuple[int, ...] = (CLASS_NEG, CLASS_POS)   # or (-1, 0, 1)
    # Tablo 5 proportions: 2-class 174669/172489; 3-class 113438/111779/109853
    class_probs: Optional[Tuple[float, ...]] = None
    num_public: int = 108
    num_private: int = 66
    min_tokens: int = 4
    max_tokens: int = 18
    # token mixture inside a message
    p_signal: float = 0.45    # class-lexicon tokens
    p_cross: float = 0.08     # wrong-class lexicon tokens (label noise)
    p_stopword: float = 0.22  # Tablo 4 noise (removed by the pipeline)
    p_neutral: float = 0.25   # topic filler
    seed: int = 0


def university_names(cfg: CorpusConfig) -> Tuple[List[str], np.ndarray]:
    pub = list(_PUBLIC_SEED)
    while len(pub) < cfg.num_public:
        pub.append(f"devlet üniversitesi {len(pub) + 1:03d}")
    pri = list(_PRIVATE_SEED)
    while len(pri) < cfg.num_private:
        pri.append(f"vakıf üniversitesi {len(pri) + 1:03d}")
    names = pub[:cfg.num_public] + pri[:cfg.num_private]
    kinds = np.array([0] * cfg.num_public + [1] * cfg.num_private)
    return names, kinds


def _default_probs(classes: Sequence[int]) -> Tuple[float, ...]:
    if tuple(classes) == (CLASS_NEG, CLASS_POS):
        tot = 174669 + 172489
        return (172489 / tot, 174669 / tot)       # (neg, pos) per Tablo 5
    if tuple(classes) == (CLASS_NEG, CLASS_NEU, CLASS_POS):
        tot = 113438 + 111779 + 109853
        return (111779 / tot, 109853 / tot, 113438 / tot)
    k = len(classes)
    return tuple(1.0 / k for _ in classes)


def _lexicon_for(c: int) -> List[str]:
    return {CLASS_NEG: NEGATIVE_LEXICON, CLASS_NEU: NEUTRAL_LEXICON,
            CLASS_POS: POSITIVE_LEXICON}[c]


def generate(cfg: CorpusConfig) -> Corpus:
    rng = np.random.default_rng(cfg.seed)
    names, kinds = university_names(cfg)
    probs = cfg.class_probs or _default_probs(cfg.classes)
    assert abs(sum(probs) - 1.0) < 1e-6

    labels = rng.choice(cfg.classes, size=cfg.num_messages, p=probs)
    # Polarity skew per university so Tablo 7/9-style rankings are non-trivial:
    # each university gets a bias that tilts its messages' class draw.
    uni_bias = rng.normal(0.0, 0.8, size=len(names))
    unis = rng.integers(0, len(names), size=cfg.num_messages)
    for i in range(cfg.num_messages):
        if len(cfg.classes) >= 2 and rng.random() < abs(np.tanh(uni_bias[unis[i]])) * 0.5:
            labels[i] = CLASS_POS if uni_bias[unis[i]] > 0 else CLASS_NEG

    texts: List[str] = []
    buckets = ("signal", "cross", "stop", "neutral")
    bucket_p = np.array([cfg.p_signal, cfg.p_cross, cfg.p_stopword,
                         cfg.p_neutral])
    bucket_p = bucket_p / bucket_p.sum()
    for i in range(cfg.num_messages):
        c = int(labels[i])
        n_tok = int(rng.integers(cfg.min_tokens, cfg.max_tokens + 1))
        lex = _lexicon_for(c)
        other = [w for cc in cfg.classes if cc != c for w in _lexicon_for(cc)]
        toks = [names[unis[i]]]
        for _ in range(n_tok):
            b = buckets[int(rng.choice(4, p=bucket_p))]
            if b == "signal":
                toks.append(str(rng.choice(lex)))
            elif b == "cross":
                toks.append(str(rng.choice(other)))
            elif b == "stop":
                toks.append(str(rng.choice(_STOPWORD_LIST)))
            else:
                toks.append(str(rng.choice(NEUTRAL_LEXICON)))
        rng.shuffle(toks)
        texts.append(" ".join(toks))
    return Corpus(texts=texts, labels=labels.astype(np.int32),
                  universities=unis.astype(np.int32),
                  university_names=names, university_kinds=kinds)

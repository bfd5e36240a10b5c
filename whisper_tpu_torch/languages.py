"""Whisper language table — 100 languages with ids and full names.

Static fact table mirrored from the reference (src/whisper.cpp:313-416);
identical to OpenAI Whisper's tokenizer LANGUAGES map. Language token id for
lang_id i is `sot + 1 + i` (reference src/whisper.cpp:4249-4259).
"""

from __future__ import annotations

from typing import Optional

# code -> (lang_id, full name). Order of ids matters (they index lang tokens).
LANGUAGES = {
    "en": (0, "english"), "zh": (1, "chinese"), "de": (2, "german"),
    "es": (3, "spanish"), "ru": (4, "russian"), "ko": (5, "korean"),
    "fr": (6, "french"), "ja": (7, "japanese"), "pt": (8, "portuguese"),
    "tr": (9, "turkish"), "pl": (10, "polish"), "ca": (11, "catalan"),
    "nl": (12, "dutch"), "ar": (13, "arabic"), "sv": (14, "swedish"),
    "it": (15, "italian"), "id": (16, "indonesian"), "hi": (17, "hindi"),
    "fi": (18, "finnish"), "vi": (19, "vietnamese"), "he": (20, "hebrew"),
    "uk": (21, "ukrainian"), "el": (22, "greek"), "ms": (23, "malay"),
    "cs": (24, "czech"), "ro": (25, "romanian"), "da": (26, "danish"),
    "hu": (27, "hungarian"), "ta": (28, "tamil"), "no": (29, "norwegian"),
    "th": (30, "thai"), "ur": (31, "urdu"), "hr": (32, "croatian"),
    "bg": (33, "bulgarian"), "lt": (34, "lithuanian"), "la": (35, "latin"),
    "mi": (36, "maori"), "ml": (37, "malayalam"), "cy": (38, "welsh"),
    "sk": (39, "slovak"), "te": (40, "telugu"), "fa": (41, "persian"),
    "lv": (42, "latvian"), "bn": (43, "bengali"), "sr": (44, "serbian"),
    "az": (45, "azerbaijani"), "sl": (46, "slovenian"), "kn": (47, "kannada"),
    "et": (48, "estonian"), "mk": (49, "macedonian"), "br": (50, "breton"),
    "eu": (51, "basque"), "is": (52, "icelandic"), "hy": (53, "armenian"),
    "ne": (54, "nepali"), "mn": (55, "mongolian"), "bs": (56, "bosnian"),
    "kk": (57, "kazakh"), "sq": (58, "albanian"), "sw": (59, "swahili"),
    "gl": (60, "galician"), "mr": (61, "marathi"), "pa": (62, "punjabi"),
    "si": (63, "sinhala"), "km": (64, "khmer"), "sn": (65, "shona"),
    "yo": (66, "yoruba"), "so": (67, "somali"), "af": (68, "afrikaans"),
    "oc": (69, "occitan"), "ka": (70, "georgian"), "be": (71, "belarusian"),
    "tg": (72, "tajik"), "sd": (73, "sindhi"), "gu": (74, "gujarati"),
    "am": (75, "amharic"), "yi": (76, "yiddish"), "lo": (77, "lao"),
    "uz": (78, "uzbek"), "fo": (79, "faroese"), "ht": (80, "haitian creole"),
    "ps": (81, "pashto"), "tk": (82, "turkmen"), "nn": (83, "nynorsk"),
    "mt": (84, "maltese"), "sa": (85, "sanskrit"), "lb": (86, "luxembourgish"),
    "my": (87, "myanmar"), "bo": (88, "tibetan"), "tl": (89, "tagalog"),
    "mg": (90, "malagasy"), "as": (91, "assamese"), "tt": (92, "tatar"),
    "haw": (93, "hawaiian"), "ln": (94, "lingala"), "ha": (95, "hausa"),
    "ba": (96, "bashkir"), "jw": (97, "javanese"), "su": (98, "sundanese"),
    "yue": (99, "cantonese"),
}

MAX_LANG_ID = max(i for i, _ in LANGUAGES.values())  # 99
ID_TO_CODE = {i: code for code, (i, _) in LANGUAGES.items()}
NAME_TO_CODE = {name: code for code, (_, name) in LANGUAGES.items()}


def lang_max_id() -> int:
    """reference whisper_lang_max_id (src/whisper.cpp:4186-4192)."""
    return MAX_LANG_ID


def lang_id(code_or_name: str) -> int:
    """Language string (code or full name) -> id; -1 if unknown.
    reference whisper_lang_id (src/whisper.cpp:4194-4210)."""
    if code_or_name in LANGUAGES:
        return LANGUAGES[code_or_name][0]
    if code_or_name in NAME_TO_CODE:
        return LANGUAGES[NAME_TO_CODE[code_or_name]][0]
    return -1


def lang_str(idx: int) -> Optional[str]:
    """id -> short code; None if out of range.
    reference whisper_lang_str (src/whisper.cpp:4212-4220)."""
    return ID_TO_CODE.get(idx)


def lang_str_full(idx: int) -> Optional[str]:
    """id -> full language name.
    reference whisper_lang_str_full (src/whisper.cpp:4222-4230)."""
    code = ID_TO_CODE.get(idx)
    return LANGUAGES[code][1] if code is not None else None

"""Locale string maps (``rvc_tpu/i18n.py``), read from the port's own copy
of the JSON files in ``locales/``."""
from __future__ import annotations

import json
import locale
import os

I18N_DIR = os.path.join(os.path.dirname(__file__), "locales")


class I18nAuto:
    """``language`` (the system's locale for None or "auto"; en_US where no
    file has it) -> a callable mapping a string to its translation, or to
    itself where the map lacks it."""

    def __init__(self, language: str | None = None):
        if language in (None, "auto"):
            language = locale.getdefaultlocale()[0] or "en_US"
        path = os.path.join(I18N_DIR, f"{language}.json")
        if not os.path.exists(path):
            language = "en_US"
            path = os.path.join(I18N_DIR, f"{language}.json")
        self.language = language
        self.language_map: dict[str, str] = {}
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.language_map = json.load(f)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def print(self) -> None:
        print(f"Using Language: {self.language}")

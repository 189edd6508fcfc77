"""Wikipedia corpus downloader: a copy of ``rag_uq_tpu/data/wikipedia.py``.

Capability parity with the reference's WikipediaDownloader
(data/preprocessing/prepare_corpus.py:81-236): random-title sampling via the
MediaWiki API, plain-text extract fetch, rate limiting between requests, a
downloaded-titles JSON checkpoint with resume, append-mode JSONL output, and
periodic checkpoint saves.

The HTTP transport is injectable (`fetch_json`): this container has zero
egress, so tests and offline runs drive the full checkpoint/resume/output
logic through a fake fetcher, while a networked deployment passes the
default requests-based fetcher.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

API_BASE = "https://en.wikipedia.org/w/api.php"
FetchFn = Callable[[str, Dict[str, Any]], Dict[str, Any]]


def requests_fetcher(timeout: float = 30.0) -> FetchFn:  # pragma: no cover
    """Default network transport (unusable in zero-egress environments)."""
    import requests

    session = requests.Session()
    session.headers.update({"User-Agent": "rag-uq-tpu/0.1 (research)"})

    def fetch(url: str, params: Dict[str, Any]) -> Dict[str, Any]:
        try:
            response = session.get(url, params=params, timeout=timeout)
            response.raise_for_status()
            return response.json()
        except requests.RequestException as e:
            logger.error("API request failed: %s", e)
            return {}

    return fetch


class WikipediaDownloader:
    """Rate-limited, checkpointed Wikipedia article downloader."""

    def __init__(
        self,
        output_dir: str = "data/raw",
        rate_limit_delay: float = 0.5,
        checkpoint_interval: int = 100,
        fetch_json: Optional[FetchFn] = None,
    ):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.rate_limit_delay = rate_limit_delay
        self.checkpoint_interval = checkpoint_interval
        self._fetch = fetch_json or requests_fetcher()
        self._last_request = 0.0

    def _make_request(self, params: Dict[str, Any]) -> Dict[str, Any]:
        wait = self.rate_limit_delay - (time.time() - self._last_request)
        if wait > 0:
            time.sleep(wait)
        self._last_request = time.time()
        return self._fetch(API_BASE, params)

    def get_random_articles(self, n_articles: int = 100) -> List[str]:
        """Random main-namespace article titles."""
        titles: List[str] = []
        while len(titles) < n_articles:
            data = self._make_request(
                {
                    "action": "query",
                    "list": "random",
                    "rnnamespace": 0,
                    "rnlimit": min(50, n_articles - len(titles)),
                    "format": "json",
                }
            )
            batch = data.get("query", {}).get("random", [])
            if not batch:
                break  # transport exhausted/failing; avoid an infinite loop
            titles.extend(item["title"] for item in batch)
            logger.info("Fetched %d/%d article titles", len(titles), n_articles)
        return titles[:n_articles]

    def get_article_content(self, title: str) -> Optional[Dict[str, Any]]:
        """Plain-text extract + metadata for one title."""
        data = self._make_request(
            {
                "action": "query",
                "titles": title,
                "prop": "extracts|info",
                "explaintext": True,
                "exsectionformat": "plain",
                "inprop": "url",
                "format": "json",
            }
        )
        pages = data.get("query", {}).get("pages", {})
        for page_id, page in pages.items():
            if page_id == "-1":
                continue
            return {
                "page_id": page_id,
                "title": page.get("title", title),
                "extract": page.get("extract", ""),
                "url": page.get(
                    "fullurl",
                    f"https://en.wikipedia.org/wiki/{title.replace(' ', '_')}",
                ),
            }
        return None

    def download_corpus(
        self,
        n_articles: int = 1000,
        output_file: str = "wikipedia_corpus.jsonl",
        resume: bool = True,
    ) -> int:
        """Download articles to JSONL with title-set checkpoint resume."""
        output_path = self.output_dir / output_file
        checkpoint_path = self.output_dir / f".{output_file}.checkpoint"

        downloaded: set = set()
        if resume and checkpoint_path.exists():
            with open(checkpoint_path) as f:
                downloaded = set(json.load(f))
            logger.info("Resuming with %d articles downloaded", len(downloaded))

        titles = self.get_random_articles(n_articles + len(downloaded))
        titles = [t for t in titles if t not in downloaded][:n_articles]
        if not titles:
            logger.info("No new articles to download")
            return len(downloaded)

        def save_checkpoint() -> None:
            with open(checkpoint_path, "w") as cp:
                json.dump(sorted(downloaded), cp)

        mode = "a" if resume and output_path.exists() else "w"
        with open(output_path, mode) as f:
            for i, title in enumerate(titles):
                article = self.get_article_content(title)
                if article and article["extract"]:
                    f.write(json.dumps(article) + "\n")
                    downloaded.add(title)
                    if (i + 1) % self.checkpoint_interval == 0:
                        save_checkpoint()
                        logger.info("Checkpoint: %d articles", len(downloaded))
        save_checkpoint()
        logger.info("Download complete: %d articles total", len(downloaded))
        return len(downloaded)

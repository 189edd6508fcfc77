"""Deterministic synthetic-wikipedia world: entities, articles, QA pairs.

A copy of ``rag_uq_tpu/data/synth_wiki.py`` (numpy only), held to it by
``tests/test_torch_data.py``.

The reference's experiments run on Wikipedia articles + Natural Questions
fetched over the network (reference: data/preprocessing/prepare_corpus.py:81-236,
:296-421). This environment has no egress, and the reference's offline
fallback is 8 template contexts — far too small to train or evaluate
anything semantic. This module generates an arbitrarily large, seeded,
wikipedia-*shaped* world instead:

- **Entities** with typed attributes (people, cities, elements, books,
  events, animals) whose names come from a syllable generator, so worlds of
  tens of thousands of entities have distinct, pronounceable surface forms.
- **Articles**: multi-sentence paragraphs over an entity's attributes,
  with the sentence templates *and* content-word synonyms sampled per
  article — so stating the same fact takes many surface forms.
- **QA pairs** whose question templates are phrased *differently* from any
  article template (and use different synonyms). Answers are attribute
  values; gold ids point at the passage(s) actually containing the answer.

The question/passage wording gap is what makes the dataset a real test of
semantic retrieval: a purely lexical embedder only matches on entity names,
while a trained encoder can also learn the question-template -> fact-template
correspondences (e.g. "penned" -> "author") and which tokens are
discriminative. Used by the encoder contrastive trainer (embed/train.py),
TinyLM fine-tuning, the experiment pipeline, and the parity harness.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# -- name generation --------------------------------------------------------------

_ONSETS = ["b", "br", "c", "ch", "d", "dr", "f", "g", "gr", "h", "j", "k",
           "kl", "l", "m", "n", "p", "pr", "r", "s", "sh", "st", "t", "th",
           "tr", "v", "w", "z"]
_VOWELS = ["a", "e", "i", "o", "u", "ae", "ia", "ei", "ou"]
_CODAS = ["", "l", "n", "r", "s", "th", "m", "nd", "rk", "sh", "x"]


def _syllable(rng: np.random.Generator) -> str:
    return (
        _ONSETS[rng.integers(len(_ONSETS))]
        + _VOWELS[rng.integers(len(_VOWELS))]
        + _CODAS[rng.integers(len(_CODAS))]
    )


def _name(rng: np.random.Generator, syllables: int) -> str:
    return "".join(_syllable(rng) for _ in range(syllables)).capitalize()


def _unique_name(rng: np.random.Generator, taken: set, syllables: int) -> str:
    for _ in range(64):
        cand = _name(rng, syllables)
        if cand not in taken:
            taken.add(cand)
            return cand
    # Extremely unlikely; extend with a numeral-free suffix syllable.
    while True:
        cand = _name(rng, syllables) + _syllable(rng)
        if cand not in taken:
            taken.add(cand)
            return cand


# -- entity world -----------------------------------------------------------------

_OCCUPATIONS = ["composer", "painter", "astronomer", "botanist", "architect",
                "poet", "chemist", "cartographer", "sculptor", "physician",
                "philosopher", "engineer", "historian", "naturalist"]
_GENRES = ["poetry", "satire", "tragedy", "natural history", "philosophy",
           "travel writing", "epic verse", "political theory"]
_HABITATS = ["wetlands", "alpine meadows", "coastal cliffs", "rainforest canopy",
             "arid steppe", "river deltas", "temperate woodland", "tidal flats"]
_DIETS = ["insects and larvae", "aquatic plants", "small rodents", "nectar",
          "carrion", "fish and crustaceans", "seeds and berries", "grasses"]
_LANDMARK_KINDS = ["cathedral", "observatory", "bridge", "citadel", "library",
                   "botanical garden", "amphitheatre", "clock tower"]
_EVENT_KINDS = ["treaty", "council", "uprising", "expedition", "synod",
                "exposition", "siege", "congress"]


@dataclass
class Entity:
    kind: str  # person | city | element | book | event | animal
    name: str
    attrs: Dict[str, str]
    # Paraphrase-stress alias: a surface form that refers to this entity but
    # NEVER appears in any article text (assigned only when a world is
    # generated with alias questions). A BM25 query using the alias has no
    # lexical bridge to the gold article — only a trained encoder that has
    # seen the alias in training questions can retrieve it.
    alias: str = ""


@dataclass
class QA:
    id: str
    question: str
    answers: List[str]
    entity: str
    attribute: str
    gold_doc_ids: List[str] = field(default_factory=list)
    context: str = ""
    # "lexical": the question names the entity (BM25-friendly).
    # "semantic": the question uses the entity's alias, which occurs in no
    # article — lexical retrieval fails by construction, dense must bridge.
    # "lookup": the question names NO entity, only a conjunction of
    # moderately-common attribute values whose combination is unique —
    # term-weighted sparse scoring succeeds, single-vector dense struggles.
    # "inverse": the question names a unique attribute VALUE (work,
    # landmark, river) and the answer is the entity name — one rare-term
    # exact match, decisively BM25-favoring.
    slice: str = "lexical"


@dataclass
class World:
    """A generated world: entities, one article per entity, QA pairs."""

    entities: List[Entity]
    articles: List[Dict]  # {"id", "title", "text"}
    qas: List[QA]

    def corpus_rows(self) -> List[Dict]:
        return [dict(a) for a in self.articles]

    def qa_rows(self) -> List[Dict]:
        return [
            {
                "id": q.id,
                "question": q.question,
                "answers": q.answers,
                "context": q.context,
                "gold_doc_ids": q.gold_doc_ids,
                "metadata": {
                    "entity": q.entity,
                    "attribute": q.attribute,
                    "slice": q.slice,
                },
            }
            for q in self.qas
        ]


def _make_entities(rng: np.random.Generator, n: int) -> List[Entity]:
    taken: set = set()
    # A small shared geography every world draws from, so cross-entity
    # references (birthplaces, locations) repeat like real-world city names.
    n_cities = max(6, n // 8)
    n_countries = max(3, n_cities // 5)
    countries = [_unique_name(rng, taken, 3) for _ in range(n_countries)]
    cities: List[Entity] = []
    for _ in range(n_cities):
        name = _unique_name(rng, taken, 2)
        cities.append(Entity("city", name, {
            "country": countries[rng.integers(n_countries)],
            "population": str(int(rng.integers(40, 4000)) * 1000),
            "river": _unique_name(rng, taken, 2),
            "landmark_kind": _LANDMARK_KINDS[rng.integers(len(_LANDMARK_KINDS))],
            "landmark": _unique_name(rng, taken, 2),
            "founded": str(int(rng.integers(800, 1700))),
        }))

    entities: List[Entity] = list(cities)
    kinds = ["person", "element", "book", "event", "animal"]
    while len(entities) < n:
        kind = kinds[rng.integers(len(kinds))]
        city = cities[rng.integers(len(cities))]
        if kind == "person":
            first, last = _unique_name(rng, taken, 2), _unique_name(rng, taken, 2)
            birth = int(rng.integers(1500, 1950))
            entities.append(Entity("person", f"{first} {last}", {
                "birth_year": str(birth),
                "death_year": str(birth + int(rng.integers(35, 90))),
                "birth_city": city.name,
                "occupation": _OCCUPATIONS[rng.integers(len(_OCCUPATIONS))],
                "work": _unique_name(rng, taken, 3),
            }))
        elif kind == "element":
            name = _unique_name(rng, taken, 3)
            entities.append(Entity("element", name, {
                "symbol": (name[:2]).capitalize(),
                "atomic_number": str(int(rng.integers(1, 200))),
                "discovered": str(int(rng.integers(1650, 1990))),
                "color": ["silvery", "pale yellow", "bluish", "dark grey",
                          "reddish"][rng.integers(5)],
            }))
        elif kind == "book":
            title = f"The {_unique_name(rng, taken, 2)} of {_unique_name(rng, taken, 2)}"
            entities.append(Entity("book", title, {
                "author": f"{_unique_name(rng, taken, 2)} {_unique_name(rng, taken, 2)}",
                "year": str(int(rng.integers(1500, 2000))),
                "genre": _GENRES[rng.integers(len(_GENRES))],
                "city": city.name,
            }))
        elif kind == "event":
            name = (f"the {_EVENT_KINDS[rng.integers(len(_EVENT_KINDS))].capitalize()} "
                    f"of {_unique_name(rng, taken, 2)}")
            start = int(rng.integers(900, 1950))
            entities.append(Entity("event", name, {
                "start_year": str(start),
                "duration_years": str(int(rng.integers(1, 12))),
                "city": city.name,
            }))
        else:  # animal
            species = f"{_unique_name(rng, taken, 2)} {_unique_name(rng, taken, 2).lower()}"
            entities.append(Entity("animal", species, {
                "habitat": _HABITATS[rng.integers(len(_HABITATS))],
                "diet": _DIETS[rng.integers(len(_DIETS))],
                "lifespan": str(int(rng.integers(2, 60))),
            }))
    return entities


# -- article templates --------------------------------------------------------------
# Several surface forms per (kind, attribute) fact; one is sampled per article.

_FACT_TEMPLATES: Dict[Tuple[str, str], List[str]] = {
    ("person", "birth"): [
        "{name} was born in {birth_city} in {birth_year}.",
        "Born in {birth_city} in {birth_year}, {name} showed early promise.",
        "{name} came into the world at {birth_city} in the year {birth_year}.",
    ],
    ("person", "occupation"): [
        "{name} was a celebrated {occupation}.",
        "{name} worked for decades as a {occupation}.",
        "By profession, {name} was a {occupation}.",
    ],
    ("person", "work"): [
        "{name} is best known for {work}.",
        "The most famous creation of {name} remains {work}.",
        "{name} achieved lasting renown with {work}.",
    ],
    ("person", "death"): [
        "{name} died in {death_year}.",
        "{name} passed away in {death_year}.",
    ],
    ("city", "country"): [
        "{name} is a city in {country}.",
        "{name} lies in the heart of {country}.",
        "The city of {name} belongs to {country}.",
    ],
    ("city", "population"): [
        "{name} has a population of about {population} inhabitants.",
        "Roughly {population} people live in {name}.",
    ],
    ("city", "river"): [
        "{name} stands on the banks of the river {river}.",
        "The river {river} flows through {name}.",
    ],
    ("city", "landmark"): [
        "Its best-known landmark is the {landmark} {landmark_kind}.",
        "Visitors come to {name} for the {landmark} {landmark_kind}.",
    ],
    ("city", "founded"): [
        "{name} was founded around {founded}.",
        "The settlement of {name} dates back to {founded}.",
    ],
    ("element", "symbol"): [
        "{name} is a chemical element with symbol {symbol}.",
        "The element {name} carries the symbol {symbol}.",
    ],
    ("element", "atomic_number"): [
        "{name} has atomic number {atomic_number}.",
        "With atomic number {atomic_number}, {name} sits in the periodic table.",
    ],
    ("element", "discovered"): [
        "{name} was discovered in {discovered}.",
        "Chemists first isolated {name} in {discovered}.",
    ],
    ("element", "color"): [
        "In pure form {name} appears {color}.",
        "{name} is a {color} substance at room temperature.",
    ],
    ("book", "author"): [
        "{name} was written by {author}.",
        "{author} is the author of {name}.",
        "{name} is a work by {author}.",
    ],
    ("book", "year"): [
        "{name} was published in {year}.",
        "{name} first appeared in print in {year}.",
    ],
    ("book", "genre"): [
        "{name} is regarded as a classic of {genre}.",
        "The book is an influential example of {genre}.",
    ],
    ("event", "start"): [
        "{name} began in {start_year}.",
        "{name} started in the year {start_year}.",
    ],
    ("event", "city"): [
        "{name} took place in {city}.",
        "{name} unfolded in the city of {city}.",
    ],
    ("animal", "habitat"): [
        "The {name} inhabits {habitat}.",
        "The {name} is native to {habitat}.",
        "Populations of the {name} are found across {habitat}.",
    ],
    ("animal", "diet"): [
        "The {name} feeds mainly on {diet}.",
        "Its diet consists largely of {diet}.",
    ],
    ("animal", "lifespan"): [
        "The {name} lives for about {lifespan} years.",
        "A typical {name} reaches an age of {lifespan} years.",
    ],
}

_FACT_ORDER: Dict[str, List[str]] = {
    "person": ["birth", "occupation", "work", "death"],
    "city": ["country", "population", "river", "landmark", "founded"],
    "element": ["symbol", "atomic_number", "discovered", "color"],
    "book": ["author", "year", "genre"],
    "event": ["start", "city"],
    "animal": ["habitat", "diet", "lifespan"],
}

# -- question templates --------------------------------------------------------------
# Deliberately phrased differently from every article template: shared
# content words are mostly the entity name + attribute value; the rest of
# the wording must be bridged semantically.

_QUESTION_TEMPLATES: Dict[Tuple[str, str], Tuple[List[str], str]] = {
    ("person", "birth_year"): (
        ["In which year was {name} born?",
         "What year saw the birth of {name}?"], "birth_year"),
    ("person", "birth_city"): (
        ["Where was {name} born?",
         "Which city is the birthplace of {name}?"], "birth_city"),
    ("person", "occupation"): (
        ["What did {name} do for a living?",
         "What was the profession of {name}?"], "occupation"),
    ("person", "work"): (
        ["Which creation made {name} famous?",
         "What is {name} chiefly remembered for?"], "work"),
    ("city", "country"): (
        ["In what country is {name} located?",
         "Which nation does {name} belong to?"], "country"),
    ("city", "river"): (
        ["On which river does {name} stand?",
         "What waterway runs through {name}?"], "river"),
    ("city", "population"): (
        ["How many people live in {name}?",
         "What is the population of {name}?"], "population"),
    ("city", "founded"): (
        ["When was {name} established?",
         "Around what year did {name} come into existence?"], "founded"),
    ("element", "symbol"): (
        ["What symbol denotes the element {name}?",
         "Which abbreviation stands for {name}?"], "symbol"),
    ("element", "atomic_number"): (
        ["What is the atomic number of {name}?",
         "Which number does {name} hold in the periodic table?"],
        "atomic_number"),
    ("element", "discovered"): (
        ["When was {name} first identified?",
         "In what year did scientists find {name}?"], "discovered"),
    ("book", "author"): (
        ["Who penned {name}?",
         "Which writer produced {name}?"], "author"),
    ("book", "year"): (
        ["When did {name} come out?",
         "In what year was {name} released?"], "year"),
    ("event", "start_year"): (
        ["When did {name} get under way?",
         "In which year did {name} commence?"], "start_year"),
    ("event", "city"): (
        ["Where did {name} happen?",
         "Which city hosted {name}?"], "city"),
    ("animal", "habitat"): (
        ["Where does the {name} live?",
         "In what environment is the {name} found?"], "habitat"),
    ("animal", "diet"): (
        ["What does the {name} eat?",
         "What food sustains the {name}?"], "diet"),
    ("animal", "lifespan"): (
        ["How long does a {name} live?",
         "What age can the {name} reach?"], "lifespan"),
}


# -- v2 question style ---------------------------------------------------------------
# The hand-written out-of-family eval (runs/demo_full_r3/results/handwritten/)
# measured EM 0.095 vs the synthetic split's 0.49 and localized the cause:
# (a) v1 asks every attribute in exactly two formal registers, while natural
# questions are also elliptical ("{name}'s population?"), inverted ("{name}
# sits in which country?") and colloquial; (b) four attributes that appear in
# every article (death year, landmark, element color, book genre) are never
# asked at all, so the extractor has never learned to read them out. The v2
# style widens both axes AT TRAINING-DATA GENERATION TIME ONLY — the
# hand-written split stays fully held out (none of these strings reproduce a
# hand-written question), and `question_style="v1"` (the default) remains
# byte-identical to earlier rounds' worlds.

_QUESTION_TEMPLATES_V2_EXTRA: Dict[Tuple[str, str], List[str]] = {
    ("person", "birth_year"): [
        "When was {name} born?",
        "{name} was born in which year?",
        "{name}'s year of birth?",
    ],
    ("person", "birth_city"): [
        "{name} was born where?",
        "{name}'s birthplace?",
        "In which city was {name} born?",
    ],
    ("person", "occupation"): [
        "{name}'s profession?",
        "What kind of work did {name} do?",
        "{name} earned a living as what?",
    ],
    ("person", "work"): [
        "{name}'s best-known creation?",
        "What work is {name} famous for?",
        "{name} is remembered chiefly for what?",
    ],
    ("city", "country"): [
        "{name} sits in which country?",
        "Which country is {name} in?",
        "{name}'s country?",
    ],
    ("city", "river"): [
        "Which river passes {name}?",
        "{name} stands on which river?",
        "What river does {name} sit beside?",
    ],
    ("city", "population"): [
        "How big is {name}'s population?",
        "{name} has how many inhabitants?",
        "How many residents does {name} have?",
    ],
    ("city", "founded"): [
        "{name} was founded in what year?",
        "{name} dates back to when?",
        "The founding year of {name}?",
    ],
    ("element", "symbol"): [
        "{name}'s chemical symbol?",
        "What is the symbol for {name}?",
        "The element {name} is written with which symbol?",
    ],
    ("element", "atomic_number"): [
        "{name}'s atomic number?",
        "What number does {name} have in the periodic table?",
        "The atomic number of {name} is what?",
    ],
    ("element", "discovered"): [
        "When was {name} discovered?",
        "{name}'s year of discovery?",
        "{name} was first isolated in which year?",
    ],
    ("book", "author"): [
        "Who wrote {name}?",
        "{name} was written by whom?",
        "Who is the author of {name}?",
    ],
    ("book", "year"): [
        "{name} was published when?",
        "{name}'s publication year?",
        "Which year saw the publication of {name}?",
    ],
    ("event", "start_year"): [
        "{name} began in which year?",
        "When did {name} start?",
        "{name} kicked off in what year?",
    ],
    ("event", "city"): [
        "{name} took place where?",
        "In which city did {name} occur?",
        "{name}'s host city?",
    ],
    ("animal", "habitat"): [
        "The {name} is found where?",
        "What habitat does the {name} prefer?",
        "Where is the {name} native to?",
    ],
    ("animal", "diet"): [
        "The {name} feeds on what?",
        "What is the diet of the {name}?",
        "The {name} mainly eats what?",
    ],
    ("animal", "lifespan"): [
        "What is the lifespan of the {name}?",
        "The {name} reaches what age?",
        "How many years does a {name} live?",
    ],
}

_QUESTION_TEMPLATES_V2_NEW: Dict[Tuple[str, str], Tuple[List[str], str]] = {
    ("person", "death_year"): (
        ["When did {name} die?",
         "In what year did {name} pass away?",
         "{name} died in which year?",
         "{name}'s year of death?"], "death_year"),
    ("city", "landmark"): (
        ["What is the best-known landmark of {name}?",
         "Which landmark draws visitors to {name}?",
         "{name}'s most famous landmark?"], "landmark"),
    ("element", "color"): (
        ["What color is {name} in pure form?",
         "{name} appears what color?",
         "What is the color of {name}?"], "color"),
    ("book", "genre"): (
        ["What genre is {name}?",
         "{name} is a classic of which genre?",
         "To which genre does {name} belong?"], "genre"),
}


def _question_table(
    style: str,
) -> Dict[Tuple[str, str], Tuple[List[str], str]]:
    if style == "v1":
        return _QUESTION_TEMPLATES
    if style != "v2":
        raise ValueError(f"unknown question_style {style!r} (v1 or v2)")
    table = {
        key: (tmpls + _QUESTION_TEMPLATES_V2_EXTRA.get(key, []), attr_key)
        for key, (tmpls, attr_key) in _QUESTION_TEMPLATES.items()
    }
    table.update(_QUESTION_TEMPLATES_V2_NEW)
    return table


# -- lookup (conjunctive archive) templates -----------------------------------------
# The inverse of the question templates above: the entity is the ANSWER and
# the question names only a conjunction of attribute values. Each value alone
# is moderately common (habitats/diets are shared by ~1/8 of animals,
# lifespans by ~1/58), so no single query token identifies the gold article —
# only the conjunction does. Term-weighted sparse scoring (BM25 sums idf over
# all matched constraints) resolves the conjunction; a single mean-pooled
# query vector cannot express "matches A AND B AND C" against hundreds of
# near-duplicate articles that each satisfy a subset. This is the
# bm25-favoring twin of the alias ("semantic") split, giving the learned
# router a genuine per-query decision (VERDICT r2 next #3).
#
# Wording constraint: the BM25 tokenizer is bare lowercase+whitespace split
# (text/tokenize.py parity contract), so a value token followed by
# punctuation hashes differently from its clean article-side form. Templates
# below keep every constraint value mid-phrase; multi-word values (habitat,
# diet) always contribute at least one clean token on both sides.

_LOOKUP_TEMPLATES: List[str] = [
    "Which animal of the {habitat} feeds on {diet} and lives about "
    "{lifespan} years?",
    "What animal lives roughly {lifespan} years, eats {diet} and is found "
    "in {habitat} country?",
    "Name the {habitat} animal whose diet is {diet} and whose lifespan is "
    "around {lifespan} years.",
    "An animal dwelling in {habitat} that eats {diet} and reaches "
    "{lifespan} years of age — which is it?",
]


# -- inverse-direction templates -----------------------------------------------------
# The question names a unique ATTRIBUTE VALUE of the entity (its famous
# work, its landmark, its river) and the ANSWER is the entity name — the
# direction the hand-written hw_inverse slice probes, which no base
# template covers (base questions always name the entity and ask for an
# attribute). The named value is a globally unique generated token that
# appears exactly ONCE in the whole corpus, inside the gold article, often
# sentence-finally — so these queries are decisively BM25-favoring (one
# rare-term exact match) while a mean-pooled dense vector sees the value as
# one token among a full article. Routing training data without this family
# leaves "single rare-token needle" queries out of distribution for the
# gate (measured: router misroutes hand-written inverse questions to dense,
# runs/demo_full_r3/results/handwritten_retrieval_slices.json).
_INVERSE_TEMPLATES: Dict[str, List[Tuple[List[str], str]]] = {
    "person": [
        (["Who created {work}?",
          "Which figure is chiefly remembered for {work}?",
          "Whose most famous creation is {work}?"], "work"),
    ],
    "city": [
        (["Which city is known for the {landmark} {landmark_kind}?",
          "Where would a visitor find the {landmark} {landmark_kind}?"],
         "landmark"),
        (["Which city stands on the river {river}?",
          "Through which city does the river {river} flow?"], "river"),
    ],
}


def _article_text(rng: np.random.Generator, ent: Entity) -> str:
    fields = {"name": ent.name, **ent.attrs}
    sentences = []
    for fact in _FACT_ORDER[ent.kind]:
        options = _FACT_TEMPLATES[(ent.kind, fact)]
        sentences.append(options[rng.integers(len(options))].format(**fields))
    # Light shuffle of the middle sentences: surface order varies, the lead
    # sentence (the most identifying) stays first like real encyclopedias.
    if len(sentences) > 2:
        mid = sentences[1:]
        rng.shuffle(mid)
        sentences = sentences[:1] + mid
    return " ".join(sentences)


def generate_world(
    n_articles: int = 1000,
    questions_per_entity: int = 2,
    seed: int = 0,
    alias_questions_per_entity: int = 0,
    lookup_questions_per_entity: int = 0,
    inverse_questions_per_entity: int = 0,
    question_style: str = "v1",
) -> World:
    """Generate a deterministic world of `n_articles` single-entity articles.

    Gold ids are verified: every QA's answer string appears in its gold
    article text (questions whose attribute phrasing can't guarantee that
    are dropped, so the returned QAs are always gold-consistent).

    With `alias_questions_per_entity > 0`, each entity additionally gets a
    unique two-word alias ("known as ...") that appears in NO article, and
    that many extra questions phrased through the alias (slice="semantic").
    These queries have no lexical overlap with their gold article beyond
    template stopwords, so BM25 fails on them by construction while a dense
    encoder trained on (alias question, gold passage) pairs can bridge them
    — the paraphrase-stress split VERDICT r2 next #3 asks for. Aliases are
    drawn from an independent rng stream so worlds WITHOUT alias questions
    are byte-identical to earlier rounds' artifacts.

    With `lookup_questions_per_entity > 0`, each ANIMAL entity whose
    (habitat, diet, lifespan) value triple is unique among animals gets up
    to that many conjunctive "archive lookup" questions (slice="lookup",
    capped at len(_LOOKUP_TEMPLATES)): the question names only the three
    attribute values, the answer is the species name. Every constraint is
    moderately common on its own, so these favor term-weighted sparse
    retrieval over single-vector dense — the mirror image of the alias
    split. Also an independent rng stream: the base (and alias) worlds stay
    byte-identical when lookups are enabled.

    With `inverse_questions_per_entity > 0`, person and city entities get
    up to that many inverse-direction questions (slice="inverse"): the
    question names a globally unique attribute value (the person's famous
    work, the city's landmark or river) and the answer is the entity name
    (_INVERSE_TEMPLATES). Independent rng stream, like the other extra
    families, so existing worlds are unperturbed.

    `question_style` selects the question template table: "v1" (default,
    byte-identical to earlier rounds' worlds) or "v2", which widens each
    attribute's phrasing registers (elliptical/inverted/colloquial) and asks
    the four article attributes v1 never asks (death year, landmark, element
    color, book genre) — see the _QUESTION_TEMPLATES_V2_* comment.
    """
    rng = np.random.default_rng(seed)
    entities = _make_entities(rng, n_articles)
    articles = []
    for i, ent in enumerate(entities):
        articles.append({
            "id": f"art_{i}",
            "title": ent.name,
            "text": _article_text(rng, ent),
            "metadata": {"kind": ent.kind, "entity": ent.name},
        })

    qtable = _question_table(question_style)
    q_keys_by_kind: Dict[str, List[Tuple[str, str]]] = {}
    for (kind, attr) in qtable:
        q_keys_by_kind.setdefault(kind, []).append((kind, attr))

    qas: List[QA] = []
    for i, ent in enumerate(entities):
        keys = q_keys_by_kind[ent.kind]
        order = rng.permutation(len(keys))
        made = 0
        for j in order:
            if made >= questions_per_entity:
                break
            kind, attr = keys[int(j)]
            templates, attr_key = qtable[(kind, attr)]
            answer = ent.attrs.get(attr_key)
            if not answer or answer not in articles[i]["text"]:
                continue
            q = templates[rng.integers(len(templates))].format(name=ent.name)
            qas.append(QA(
                id=f"qa_{len(qas)}",
                question=q,
                answers=[answer],
                entity=ent.name,
                attribute=attr_key,
                gold_doc_ids=[articles[i]["id"]],
                context=articles[i]["text"],
            ))
            made += 1

    if alias_questions_per_entity > 0:
        # Independent stream: adding aliases must not perturb the base world.
        arng = np.random.default_rng((seed ^ 0xA11A5) & 0x7FFFFFFF)
        # The alias must appear in NO article text or the semantic slice
        # gains a lexical bridge (BM25 stops failing by construction). The
        # uniqueness set therefore holds EVERY word visible in any article
        # — river/landmark/country/work names, author first/last words,
        # template vocabulary — not just entity names. _name() output is
        # capitalize()-form, so storing each token's capitalize()-form makes
        # the exact-membership check case-insensitive in effect.
        taken = {e.name for e in entities}
        for word_set in (_OCCUPATIONS, _GENRES, _HABITATS, _DIETS):
            taken.update(word_set)
        for art in articles:
            for tok in re.findall(r"[A-Za-z]+", art["text"]):
                taken.add(tok.capitalize())
        for i, ent in enumerate(entities):
            ent.alias = (
                f"{_unique_name(arng, taken, 2)} {_unique_name(arng, taken, 2)}"
            )
            keys = q_keys_by_kind[ent.kind]
            order = arng.permutation(len(keys))
            made = 0
            for j in order:
                if made >= alias_questions_per_entity:
                    break
                kind, attr = keys[int(j)]
                templates, attr_key = qtable[(kind, attr)]
                answer = ent.attrs.get(attr_key)
                if not answer or answer not in articles[i]["text"]:
                    continue
                q = templates[arng.integers(len(templates))].format(
                    name=ent.alias
                )
                qas.append(QA(
                    id=f"qa_{len(qas)}",
                    question=q,
                    answers=[answer],
                    entity=ent.name,
                    attribute=attr_key,
                    gold_doc_ids=[articles[i]["id"]],
                    context=articles[i]["text"],
                    slice="semantic",
                ))
                made += 1

    if lookup_questions_per_entity > 0:
        # Independent stream (like the alias stream): enabling lookups must
        # not perturb the base or alias questions.
        lrng = np.random.default_rng((seed ^ 0x100C0B) & 0x7FFFFFFF)
        triple_counts: Dict[Tuple[str, str, str], int] = {}
        for ent in entities:
            if ent.kind != "animal":
                continue
            key = (ent.attrs["habitat"], ent.attrs["diet"], ent.attrs["lifespan"])
            triple_counts[key] = triple_counts.get(key, 0) + 1
        n_lookup = min(lookup_questions_per_entity, len(_LOOKUP_TEMPLATES))
        for i, ent in enumerate(entities):
            if ent.kind != "animal":
                continue
            key = (ent.attrs["habitat"], ent.attrs["diet"], ent.attrs["lifespan"])
            if triple_counts[key] != 1:
                continue  # conjunction must identify exactly one animal
            if ent.name not in articles[i]["text"]:
                continue
            order = lrng.permutation(len(_LOOKUP_TEMPLATES))[:n_lookup]
            for j in order:
                q = _LOOKUP_TEMPLATES[int(j)].format(
                    habitat=ent.attrs["habitat"],
                    diet=ent.attrs["diet"],
                    lifespan=ent.attrs["lifespan"],
                )
                qas.append(QA(
                    id=f"qa_{len(qas)}",
                    question=q,
                    answers=[ent.name],
                    entity=ent.name,
                    attribute="lookup",
                    gold_doc_ids=[articles[i]["id"]],
                    context=articles[i]["text"],
                    slice="lookup",
                ))

    if inverse_questions_per_entity > 0:
        # Independent stream: enabling inverse questions must not perturb
        # the base/alias/lookup questions of the same seed.
        irng = np.random.default_rng((seed ^ 0x1472E5) & 0x7FFFFFFF)
        for i, ent in enumerate(entities):
            specs = _INVERSE_TEMPLATES.get(ent.kind)
            if not specs:
                continue
            text = articles[i]["text"]
            made = 0
            for order_j in irng.permutation(len(specs)):
                if made >= inverse_questions_per_entity:
                    break
                templates, attr_key = specs[int(order_j)]
                value = ent.attrs.get(attr_key)
                # Gold consistency both ways: the named value must occur in
                # the gold article (it's the lexical needle) and the answer
                # (the entity name) must be extractable from that article.
                if not value or value not in text or ent.name not in text:
                    continue
                q = templates[irng.integers(len(templates))].format(
                    **{"name": ent.name, **ent.attrs}
                )
                qas.append(QA(
                    id=f"qa_{len(qas)}",
                    question=q,
                    answers=[ent.name],
                    entity=ent.name,
                    attribute=f"inverse_{attr_key}",
                    gold_doc_ids=[articles[i]["id"]],
                    context=text,
                    slice="inverse",
                ))
                made += 1

    logger.info(
        "Generated world: %d articles, %d QA pairs (seed %d)",
        len(articles), len(qas), seed,
    )
    return World(entities=entities, articles=articles, qas=qas)


def write_world(
    world: World, corpus_path: str, qa_path: Optional[str] = None
) -> Tuple[int, int]:
    """Write the world as corpus + QA JSONL files (loaders.py schemas)."""
    from rag_uq_tpu_torch.data.loaders import write_jsonl

    write_jsonl(corpus_path, world.corpus_rows())
    if qa_path:
        write_jsonl(qa_path, world.qa_rows())
    return len(world.articles), len(world.qas)

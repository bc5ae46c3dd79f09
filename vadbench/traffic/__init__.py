"""Traffic: each mix is a JSON file of parameters (`<name>.json`, its
"kind" names its module in `vadbench/kinds/`); `audio` makes the seeded audio."""

/* Game value of Connect-4 positions (7 columns x 6 rows) under perfect play.

   Reads one position a line, "<stones of the side to move> <all stones>", as
   bitboards of 7 bits a column (bit 0 the bottom cell, bit 6 a sentinel),
   column a in the lowest bits; prints one line each: 1 if the side to move
   wins, 0 a draw, -1 a loss.

   A weak solver after Pascal Pons' (http://blog.gamesolver.org): negamax
   with alpha-beta over bitboards, moves that hand the opponent an immediate
   win left out, centre-first ordering by the threats a move makes, and a
   transposition table of upper and lower bounds, kept across positions. Two
   null-window searches, (0, 1) then (-1, 0), give the value's sign.

       cc -O3 -o connect4_solve connect4_solve.c && ./connect4_solve < in */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

typedef uint64_t u64;
enum { W = 7, H = 6, H1 = 7 };
#define MIN_SCORE (-(W * H) / 2 + 3)
#define MAX_SCORE ((W * H + 1) / 2 - 3)
#define TT_SIZE 33554467u /* a prime above 2^25: key mod size and its low 32 bits fix the key */

static const u64 BOTTOM = 0x40810204081ULL; /* bit 0 of every column */
static const u64 BOARD = 0x40810204081ULL * 63;
static const int ORDER[W] = {3, 2, 4, 1, 5, 0, 6};
static u64 *table; /* key's low 32 bits << 8 | value; 0 empty */

static u64 col_mask(int c) { return (u64)63 << (c * H1); }

/* empty cells that would complete four of the stones p */
static u64 win_cells(u64 p, u64 mask) {
  static const int S[3] = {H1, H1 - 1, H1 + 1};
  u64 r = (p << 1) & (p << 2) & (p << 3), q;
  for (int i = 0; i < 3; i++) {
    int s = S[i];
    q = (p << s) & (p << 2 * s);
    r |= q & (p << 3 * s);
    r |= q & (p >> s);
    q = (p >> s) & (p >> 2 * s);
    r |= q & (p << s);
    r |= q & (p >> 3 * s);
  }
  return r & (BOARD ^ mask);
}

static int tt_get(u64 key) {
  u64 e = table[key % TT_SIZE];
  return (uint32_t)(e >> 8) == (uint32_t)key ? (int)(e & 0xff) : 0;
}

static void tt_put(u64 key, int v) { table[key % TT_SIZE] = ((u64)(uint32_t)key << 8) | (u64)v; }

/* the side to move cannot win at once */
static int negamax(u64 cur, u64 mask, int moves, int alpha, int beta) {
  u64 possible = (mask + BOTTOM) & BOARD;
  u64 opp_win = win_cells(cur ^ mask, mask);
  u64 forced = possible & opp_win;
  if (forced) {
    if (forced & (forced - 1)) return -(W * H - moves) / 2;
    possible = forced;
  }
  u64 next = possible & ~(opp_win >> 1);
  if (!next) return -(W * H - moves) / 2;
  if (moves >= W * H - 2) return 0;
  int min = -(W * H - 2 - moves) / 2;
  if (alpha < min && (alpha = min) >= beta) return alpha;
  int max = (W * H - 1 - moves) / 2;
  if (beta > max && alpha >= (beta = max)) return beta;
  u64 key = cur + mask;
  int val = tt_get(key);
  if (val > MAX_SCORE - MIN_SCORE + 1) {
    min = val + 2 * MIN_SCORE - MAX_SCORE - 2;
    if (alpha < min && (alpha = min) >= beta) return alpha;
  } else if (val) {
    max = val + MIN_SCORE - 1;
    if (beta > max && alpha >= (beta = max)) return beta;
  }
  u64 mv[W];
  int sc[W], n = 0;
  for (int i = W; i--;) {
    u64 m = next & col_mask(ORDER[i]);
    if (!m) continue;
    int s = __builtin_popcountll(win_cells(cur | m, mask)), j = n++;
    for (; j && sc[j - 1] > s; j--) {
      mv[j] = mv[j - 1];
      sc[j] = sc[j - 1];
    }
    mv[j] = m;
    sc[j] = s;
  }
  while (n) {
    int score = -negamax(cur ^ mask, mask | mv[--n], moves + 1, -beta, -alpha);
    if (score >= beta) {
      tt_put(key, score + MAX_SCORE - 2 * MIN_SCORE + 2);
      return score;
    }
    if (score > alpha) alpha = score;
  }
  tt_put(key, alpha - MIN_SCORE + 1);
  return alpha;
}

int main(void) {
  unsigned long long cur, mask;
  table = calloc(TT_SIZE, sizeof *table);
  if (!table) return 1;
  while (scanf("%llu %llu", &cur, &mask) == 2) {
    int moves = __builtin_popcountll(mask), r;
    if (win_cells(cur, mask) & (mask + BOTTOM) & BOARD)
      r = 1;
    else if (negamax(cur, mask, moves, 0, 1) > 0)
      r = 1;
    else
      r = negamax(cur, mask, moves, -1, 0) < 0 ? -1 : 0;
    printf("%d\n", r);
    fflush(stdout);
  }
  return 0;
}
